"""Observability planes of the port: metrics, tracing spans, the flight
recorder and the invariant doctor (copies of the JAX package's jax-free
``util`` modules), and the device plane (``xprof``: program costs counted
from the model's shapes, the roofline, the memory gauges)."""
