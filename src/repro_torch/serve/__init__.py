"""Serving: the continuous-batching engine and its scheduler registry."""
