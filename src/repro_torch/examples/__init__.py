"""Runnable examples of the port, twins of the JAX package's ``examples/``."""
