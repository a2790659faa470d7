"""The plain reference of the port's benchmark: plain PyTorch, nothing of the
program under test, nothing of the JAX package."""
