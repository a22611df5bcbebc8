"""Peak rates of the card the port runs on: the denominators of the
device plane's roofline (``util/xprof.roofline``) and of the latency
waterfall's device estimates (``serve/latency_attribution``).

The port's counterpart of ``chip_spec`` in ``ray_tpu/utils/accelerator.py``:
the card is named by ``torch.cuda.get_device_name()``.  One card has an
entry, the H100 SXM; a CPU device gets the JAX package's nominal CPU
envelope, so the tests run the same arithmetic; a CUDA card without an
entry gets its name and no peaks, so roofline rows carry no utilisation
for it (never CPU numbers in their place).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

H100_SXM = "NVIDIA H100 80GB HBM3"

# Dense bf16 tensor-core flop/s and HBM bytes/s (NVIDIA H100 SXM data
# sheet; the peaks PERF.md's bounds use).
_CARD_SPECS = {
    H100_SXM: {"peak_flops": 989.4e12, "peak_hbm_bytes_per_s": 3.35e12},
}

# Nominal one-core CPU envelope (the JAX package's fallback): utilisation
# against it is order-of-magnitude only; it lets the CPU tests exercise
# the roofline and waterfall arithmetic end to end.
_CPU_SPEC = {"peak_flops": 100e9, "peak_hbm_bytes_per_s": 50e9}


def device_name() -> str:
    """The current CUDA device's name, or "cpu" when no card is
    visible."""
    import torch

    if not torch.cuda.is_available():
        return "cpu"
    return torch.cuda.get_device_name()


def chip_spec(name: Optional[str] = None) -> Dict[str, Any]:
    """``{"chip", "peak_flops", "peak_hbm_bytes_per_s"}`` for the card
    ``name`` (default: the detected one).  "cpu" gets the nominal CPU
    envelope; an unknown card gets ``None`` peaks."""
    name = name or device_name()
    if name == "cpu":
        return {"chip": "cpu", **_CPU_SPEC}
    spec = _CARD_SPECS.get(name)
    if spec is None:
        return {"chip": name, "peak_flops": None,
                "peak_hbm_bytes_per_s": None}
    return {"chip": name, **spec}
