"""Parameter interop with the JAX checkpoint format."""
