"""Models of the port: Llama-3 (serving and training), its int8 weights
and the HF Llama import, Mamba-2 / Jamba-style hybrids, the Mixtral
sparse-MoE transformer, ViT and CLIP (training)."""
