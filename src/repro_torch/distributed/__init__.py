"""Cross-host collectives (single-process subset)."""
