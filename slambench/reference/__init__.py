"""The plain reference that decides `correct`: plain PyTorch and numpy,
importing nothing of the program, the JAX package or JAX."""
