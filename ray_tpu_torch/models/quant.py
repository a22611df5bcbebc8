"""Weight-only int8 quantisation (w8a16) for serving (port of
``ray_tpu/models/quant.py``).

Weights are stored int8 with a per-output-channel absmax scale; decode
streams the int8 bytes and applies the scale where they are used: the
unfused path dequantises one layer at a time inside its layer loop
(``models/llama._deq_layer``), the fused kernels K7 and K8 read the int8
bytes and multiply their matmul RESULTS by the scale.  Quantised leaves
are ``{"q": int8, "scale": f32}`` dicts; norms, embeddings and 1-D
params stay in the compute dtype.

The quantiser divides the absmax by a TENSOR of 127s: on a CUDA tensor a
division by the Python scalar 127.0 is a product with its reciprocal,
one ulp off the true quotient that the CPU computes.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ray_tpu_torch._device import DeviceLike, resolve_device


def _is_qdict(x: Any) -> bool:
    return isinstance(x, dict) and set(x.keys()) == {"q", "scale"}


def quantize_tensor(w: torch.Tensor,
                    stacked: bool = False) -> Dict[str, torch.Tensor]:
    """Per-output-channel (last axis) absmax int8.  ``stacked`` leaves
    ([L, ...] per-layer stacks) also keep the leading layer axis in the
    scale, so slicing a layer slices q and scale together."""
    axes = tuple(range(1 if stacked else 0, w.ndim - 1))
    w32 = w.float()
    amax = w32.abs().amax(dim=axes, keepdim=True) if axes else w32.abs()
    scale = (amax / torch.full_like(amax, 127.0)).clamp(min=1e-8)
    q = torch.round(w32 / scale).clamp(-127, 127)
    return {"q": q.to(torch.int8), "scale": scale}


def dequantize_tensor(d: Dict[str, torch.Tensor],
                      dtype: torch.dtype) -> torch.Tensor:
    return d["q"].to(dtype) * d["scale"].to(dtype)


def _should_quantize(path: str, leaf: Any) -> bool:
    if not isinstance(leaf, torch.Tensor) or leaf.ndim < 2:
        return False
    lowered = path.lower()
    return not any(s in lowered for s in ("norm", "embed", "ln_"))


def quantize_params(params: Any, cast_rest: Optional[torch.dtype] = None
                    ) -> Any:
    """Quantise every weight matrix of a parameter tree (norms and
    embeddings stay full precision).  ``cast_rest`` casts the
    UNQUANTISED leaves to a serving dtype."""

    def walk(path: str, node: Any) -> Any:
        if isinstance(node, dict):
            return {k: walk(f"{path}/{k}", v) for k, v in node.items()}
        if _should_quantize(path, node):
            return quantize_tensor(node, stacked="/layers/" in path)
        if cast_rest is not None and isinstance(node, torch.Tensor):
            return node.to(cast_rest)
        return node

    return walk("", params)


def dequantize_params(qparams: Any, dtype: torch.dtype) -> Any:
    """The plain parameter tree back from a quantised one."""

    def walk(node: Any) -> Any:
        if _is_qdict(node):
            return dequantize_tensor(node, dtype)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return node

    return walk(qparams)


def quantized_bytes(qparams: Any) -> int:
    if isinstance(qparams, dict):
        return sum(quantized_bytes(v) for v in qparams.values())
    return qparams.numel() * qparams.element_size()


# -- llama helpers ----------------------------------------------------------

# Columns of the int8 head drawn and quantised at once: its scale is per
# column, so the head never exists whole in f32.
_HEAD_COLS = 16384


def init_quantized_llama(generator: torch.Generator, cfg,
                         device: DeviceLike = None) -> Any:
    """Random int8 Llama parameters made LAYER BY LAYER on ``device``
    from ``generator`` (on that device): an 8B int8 artifact never exists
    whole in full precision, only one layer's ``cfg.param_dtype``
    temporary.  Same tree, scales and scaling as the JAX package
    (normal * fan_in^-0.5, norms at one, embedding and norms in
    ``cfg.dtype``); the draws differ."""
    dev = resolve_device(device)
    d, h, kvh, hd, m = (cfg.dim, cfg.n_heads, cfg.n_kv_heads,
                        cfg.head_dim, cfg.mlp_dim)
    L, V = cfg.n_layers, cfg.vocab_size
    pd, sd = cfg.param_dtype, cfg.dtype

    def normal(shape, fan_in, dtype):
        t = torch.randn(shape, generator=generator, device=dev, dtype=dtype)
        return t.mul_(fan_in ** -0.5)

    def qleaf_stacked(shape_one, fan_in):
        scale_shape = (1,) * (len(shape_one) - 1) + (shape_one[-1],)
        outq = torch.empty((L,) + shape_one, dtype=torch.int8, device=dev)
        outs = torch.empty((L,) + scale_shape, dtype=torch.float32,
                           device=dev)
        for i in range(L):
            qd = quantize_tensor(normal(shape_one, fan_in, pd))
            outq[i] = qd["q"]
            outs[i] = qd["scale"]
        return {"q": outq, "scale": outs}

    def qleaf_head():
        outq = torch.empty((d, V), dtype=torch.int8, device=dev)
        outs = torch.empty((1, V), dtype=torch.float32, device=dev)
        for c in range(0, V, _HEAD_COLS):
            n = min(_HEAD_COLS, V - c)
            qd = quantize_tensor(normal((d, n), d, pd))
            outq[:, c:c + n] = qd["q"]
            outs[:, c:c + n] = qd["scale"]
        return {"q": outq, "scale": outs}

    params: Any = {
        "tok_embed": normal((V, d), d, sd),
        "layers": {
            "attn": {
                "wq": qleaf_stacked((d, h, hd), d),
                "wk": qleaf_stacked((d, kvh, hd), d),
                "wv": qleaf_stacked((d, kvh, hd), d),
                "wo": qleaf_stacked((h, hd, d), h * hd),
            },
            "mlp": {
                "w_gate": qleaf_stacked((d, m), d),
                "w_up": qleaf_stacked((d, m), d),
                "w_down": qleaf_stacked((m, d), m),
            },
            "ln_attn": torch.ones((L, d), dtype=sd, device=dev),
            "ln_mlp": torch.ones((L, d), dtype=sd, device=dev),
        },
        "final_norm": torch.ones((d,), dtype=sd, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = qleaf_head()
    return params


def llama_paged_adapter_quant(cfg):
    """Paged-cache engine adapter over int8 weights: the Llama serving
    functions dequantise PER LAYER inside their layer loops
    (``llama._deq_layer``), and the fused kernels read the int8 bytes."""
    from ray_tpu_torch.serve.llm_engine import llama_paged_adapter

    return llama_paged_adapter(cfg)


def fuse_for_decode(qparams: Any, cfg) -> Any:
    """Fuse each layer's q/k/v projections into ONE int8 operand
    ``attn.wqkv`` [L, d, (H+2·KVH)·hd] and gate/up into ``mlp.w_gateup``
    [L, d, 2m], re-quantised per OUTPUT channel (scales [L, 1, cols]).

    The values already sit on the original int8 grid, so the requant
    adds at most half an LSB of the finer per-channel grid.  One layer
    at a time: the extra memory is one layer's f32 temporaries beside
    the new int8 stacks.  Single-device serving only."""
    if getattr(cfg, "tensor_parallel", False):
        raise ValueError(
            "fuse_for_decode is single-device only: tensor-parallel "
            "sharding would split the concatenated qkv/gateup output "
            "axis across segment boundaries — serve tp from the "
            "unfused artifact")
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    d = cfg.dim
    attn = qparams["layers"]["attn"]
    mlp = qparams["layers"]["mlp"]
    L = attn["wq"]["q"].shape[0]
    dev = attn["wq"]["q"].device

    def deq(t, i):
        return t["q"][i].float() * t["scale"][i].float()

    def stack(cols):
        return {"q": torch.empty((L, d, cols), dtype=torch.int8, device=dev),
                "scale": torch.empty((L, 1, cols), dtype=torch.float32,
                                     device=dev)}

    wqkv = stack((H + 2 * KVH) * hd)
    w_gateup = stack(2 * mlp["w_gate"]["q"].shape[-1])
    for i in range(L):
        qkv = torch.cat([deq(attn["wq"], i).reshape(d, H * hd),
                         deq(attn["wk"], i).reshape(d, KVH * hd),
                         deq(attn["wv"], i).reshape(d, KVH * hd)], dim=1)
        gateup = torch.cat([deq(mlp["w_gate"], i), deq(mlp["w_up"], i)],
                           dim=1)
        for out, w in ((wqkv, qkv), (w_gateup, gateup)):
            qd = quantize_tensor(w)
            out["q"][i] = qd["q"]
            out["scale"][i] = qd["scale"]
        del qkv, gateup
    out = dict(qparams)
    out["layers"] = dict(qparams["layers"])
    out["layers"]["attn"] = {"wqkv": wqkv, "wo": attn["wo"]}
    out["layers"]["mlp"] = {"w_gateup": w_gateup, "w_down": mlp["w_down"]}
    return out
