"""Checkpoints in the reference's format (``ckpt``) and the mapping of
the port's parameters and train state onto its keys (``interop``)."""
