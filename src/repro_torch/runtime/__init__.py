"""The runtime's one-host parts (``repro.runtime``): the deterministic
fault schedule, membership events and the straggler monitor."""
