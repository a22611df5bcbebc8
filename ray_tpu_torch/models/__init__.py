"""Models of the port: Llama-3 (serving and training), its int8 weights,
and Mamba-2 / Jamba-style hybrids (training)."""
