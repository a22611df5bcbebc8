"""Ops of the port: attention, flash attention (K9f), paged attention
(K1, K2), ragged paged attention (K4, K5).  Each kernel's CUDA source is
under ``ray_tpu_torch/csrc``."""
