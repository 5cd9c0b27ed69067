"""The port's own copies of the JAX package's JAX-free core modules."""
