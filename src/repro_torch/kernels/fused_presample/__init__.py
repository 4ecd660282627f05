"""The survival-pruned presample pool pass."""
