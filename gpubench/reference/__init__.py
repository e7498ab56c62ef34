"""Plain float32 PyTorch references the benchmark holds the port to.
They import neither JAX nor the JAX package nor the port."""
