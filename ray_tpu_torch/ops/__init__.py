"""Ops of the port: attention, flash attention (K9f forward, K10/K11
backward), paged attention (K1, K2, K3, K13), ragged paged attention (K4,
K5, K6, K8), the fused decode layer (K7) and the Mamba-2 SSD chunk scan
(K12).  Each kernel's CUDA source is under ``ray_tpu_torch/csrc``."""
