"""Core types of the port that the serving planes raise (a copy of the
JAX package's ``core/exceptions.py`` serving errors)."""
