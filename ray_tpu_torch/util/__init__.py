"""Observability planes of the port: metrics, tracing spans, the flight
recorder and the invariant doctor (copies of the JAX package's jax-free
``util`` modules)."""
