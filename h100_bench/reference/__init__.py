"""The plain reference of the FULL face pipeline (PyTorch and NumPy): no
``jax``, no JAX package, nothing of the program under test."""
