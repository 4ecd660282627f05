"""K5: the flash-attention forward."""
