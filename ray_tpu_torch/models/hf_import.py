"""Import HuggingFace Llama weights into the port's param tree (port of
``ray_tpu/models/hf_import.py``).

Checkpoints trained or served with torch stacks load into the port's
Llama (models/llama.py) from a live model (anything with
``.state_dict()`` and ``.config``; ``transformers`` is never imported),
a ``(state_dict, config)`` pair, or a directory of ``config.json`` plus
``*.safetensors`` shards, with optional int8 quantisation for serving
(models/quant.py).

Weight layout mapping (HF stores [out, in]; the tree stores [in, ...]
with explicit head axes):

    model.embed_tokens.weight  [V, d]    -> tok_embed       [V, d]
    ...q_proj.weight           [H*hd, d] -> attn.wq         [d, H, hd]
    ...k_proj/v_proj.weight    [KVH*hd,d]-> attn.wk/wv      [d, KVH, hd]
    ...o_proj.weight           [d, H*hd] -> attn.wo         [H, hd, d]
    ...gate_proj/up_proj       [m, d]    -> mlp.w_gate/w_up [d, m]
    ...down_proj.weight        [d, m]    -> mlp.w_down      [m, d]
    input_layernorm            [d]       -> ln_attn         [d]
    post_attention_layernorm   [d]       -> ln_mlp          [d]
    model.norm.weight          [d]       -> final_norm      [d]
    lm_head.weight             [V, d]    -> lm_head         [d, V]

Both use the rotate-half RoPE convention, so no permutation is needed.

Each source tensor keeps its dtype and device until it is copied, as a
transposed view, straight into its layer's slice of the stacked output
(in ``param_dtype`` on ``device``): an 8B import in bf16 on the card
makes no f32 copy and no host copy of the tree.  ``quantize=True``
quantises one layer at a time (one layer's f32 temporaries).  The
card's machine has no ``safetensors`` package, so ``read_safetensors``
reads the public format itself: an 8-byte little-endian header length,
a JSON header of dtype, shape and data offsets per tensor, then the raw
bytes.
"""

from __future__ import annotations

import json
import mmap
import os
import struct
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.models.llama import LlamaConfig, Params
from ray_tpu_torch.models.quant import quantize_tensor


def llama_config_from_hf(hf_cfg: Any, **overrides: Any) -> LlamaConfig:
    """Translate a transformers LlamaConfig (object or dict)."""
    get = (hf_cfg.get if isinstance(hf_cfg, dict)
           else lambda k, d=None: getattr(hf_cfg, k, d))
    rope_scaling = None
    rs = get("rope_scaling")
    if rs:
        rs_get = rs.get if isinstance(rs, dict) else \
            lambda k, d=None: getattr(rs, k, d)
        rope_type = rs_get("rope_type", rs_get("type", ""))
        if rope_type != "llama3":
            raise NotImplementedError(
                f"rope_scaling type {rope_type!r} is not supported "
                f"(only the Llama-3.1 'llama3' scaling is) — importing "
                f"anyway would silently change the model's outputs"
            )
        rope_scaling = (
            float(rs_get("factor")),
            float(rs_get("low_freq_factor")),
            float(rs_get("high_freq_factor")),
            int(rs_get("original_max_position_embeddings")),
        )
    if get("attention_bias", False) or get("mlp_bias", False):
        raise NotImplementedError(
            "this importer maps bias-free Llama checkpoints; "
            "attention_bias/mlp_bias=True would be silently dropped"
        )
    kwargs = dict(
        vocab_size=get("vocab_size"),
        dim=get("hidden_size"),
        n_layers=get("num_hidden_layers"),
        n_heads=get("num_attention_heads"),
        n_kv_heads=get("num_key_value_heads",
                       get("num_attention_heads")),
        mlp_dim=get("intermediate_size"),
        max_seq_len=get("max_position_embeddings", 8192),
        rope_theta=float(get("rope_theta", 500_000.0)),
        norm_eps=float(get("rms_norm_eps", 1e-5)),
        tie_embeddings=bool(get("tie_word_embeddings", False)),
        rope_scaling=rope_scaling,
    )
    kwargs.update(overrides)
    return LlamaConfig(**kwargs)


def _as_tensor(t: Any) -> torch.Tensor:
    """A state-dict entry as a tensor in its own dtype and device (numpy
    arrays are wrapped, not copied)."""
    if isinstance(t, torch.Tensor):
        return t.detach()
    return torch.from_numpy(np.asarray(t))


def params_from_hf_state_dict(sd: Dict[str, Any], cfg: LlamaConfig,
                              param_dtype: Optional[torch.dtype] = None,
                              quantize: bool = False,
                              device: DeviceLike = None) -> Params:
    """Build the stacked param tree from an HF Llama state dict (torch
    tensors or numpy arrays) on ``device`` (default: the card).

    ``quantize=True`` quantises each weight matrix PER LAYER as it
    streams in (``quant.quantize_tensor``), so the full-precision tree
    never exists; the result equals ``quant.quantize_params`` of the
    unquantised import.  Missing and unconsumed checkpoint tensors are
    errors, not silent drops."""
    dev = resolve_device(device)
    pd = param_dtype or cfg.param_dtype
    d, h, kvh, hd, m = (cfg.dim, cfg.n_heads, cfg.n_kv_heads,
                        cfg.head_dim, cfg.mlp_dim)
    L = cfg.n_layers
    consumed = set()

    def take(name: str) -> torch.Tensor:
        if name not in sd:
            raise KeyError(
                f"HF checkpoint is missing {name!r} — is this a Llama "
                f"model with n_layers={L}?"
            )
        consumed.add(name)
        return _as_tensor(sd[name])

    def full(t: torch.Tensor) -> torch.Tensor:
        return t.to(device=dev, dtype=pd, copy=True)

    def stack(fmt: str, transform: Callable) -> Any:
        out = None
        for i in range(L):
            w = transform(take(fmt.format(i)))
            if quantize:
                qd = quantize_tensor(w.to(dev))
                if out is None:
                    out = {k: torch.empty((L,) + tuple(v.shape), device=dev,
                                          dtype=v.dtype)
                           for k, v in qd.items()}
                for k, v in qd.items():
                    out[k][i].copy_(v)
            else:
                if out is None:
                    out = torch.empty((L,) + tuple(w.shape), device=dev,
                                      dtype=pd)
                out[i].copy_(w)
        return out

    def norm_stack(fmt: str) -> torch.Tensor:
        out = torch.empty((L, d), device=dev, dtype=pd)
        for i in range(L):
            out[i].copy_(take(fmt.format(i)))
        return out

    params: Params = {
        "tok_embed": full(take("model.embed_tokens.weight")),
        "layers": {
            "attn": {
                "wq": stack("model.layers.{}.self_attn.q_proj.weight",
                            lambda w: w.T.reshape(d, h, hd)),
                "wk": stack("model.layers.{}.self_attn.k_proj.weight",
                            lambda w: w.T.reshape(d, kvh, hd)),
                "wv": stack("model.layers.{}.self_attn.v_proj.weight",
                            lambda w: w.T.reshape(d, kvh, hd)),
                "wo": stack("model.layers.{}.self_attn.o_proj.weight",
                            lambda w: w.T.reshape(h, hd, d)),
            },
            "mlp": {
                "w_gate": stack("model.layers.{}.mlp.gate_proj.weight",
                                lambda w: w.T),
                "w_up": stack("model.layers.{}.mlp.up_proj.weight",
                              lambda w: w.T),
                "w_down": stack("model.layers.{}.mlp.down_proj.weight",
                                lambda w: w.T),
            },
            "ln_attn": norm_stack(
                "model.layers.{}.input_layernorm.weight"),
            "ln_mlp": norm_stack(
                "model.layers.{}.post_attention_layernorm.weight"),
        },
        "final_norm": full(take("model.norm.weight")),
    }
    if not cfg.tie_embeddings:
        head = take("lm_head.weight").T
        params["lm_head"] = (quantize_tensor(head.to(dev)) if quantize
                             else full(head))
    leftovers = [k for k in sd
                 if k not in consumed
                 and not k.endswith("rotary_emb.inv_freq")]
    if leftovers:
        raise ValueError(
            f"unconsumed checkpoint tensors {sorted(leftovers)[:8]}"
            f"{' …' if len(leftovers) > 8 else ''} — refusing a silent "
            f"partial import"
        )
    return params


# safetensors dtype names → torch dtypes (the format's own table).
_ST_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of one ``.safetensors`` file, as CPU tensors over a
    private (copy-on-write) map of the file: nothing is read until a
    tensor is used."""
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: not a safetensors file (too short)")
        (n,) = struct.unpack("<Q", head)
        size = os.fstat(f.fileno()).st_size
        if n > size - 8:
            raise ValueError(f"{path}: header length {n} past the end of "
                             f"a {size}-byte file")
        header = json.loads(f.read(n))
        base = 8 + n
        buf = (mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
               if size > base else None)
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name!r} has dtype "
                             f"{info['dtype']!r}, which this reader does "
                             f"not map")
        shape = tuple(info["shape"])
        start, end = info["data_offsets"]
        count = int(np.prod(shape, dtype=np.int64))
        itemsize = torch.empty((), dtype=dtype).element_size()
        if end - start != count * itemsize or base + end > size:
            raise ValueError(f"{path}: tensor {name!r} of shape {shape} "
                             f"has offsets {start}..{end}")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        out[name] = torch.frombuffer(buf, dtype=dtype, count=count,
                                     offset=base + start).reshape(shape)
    return out


def _load_safetensors_dir(path: str) -> Dict[str, torch.Tensor]:
    shards = sorted(f for f in os.listdir(path)
                    if f.endswith(".safetensors"))
    if not shards:
        raise FileNotFoundError(f"no .safetensors files under {path!r}")
    sd: Dict[str, torch.Tensor] = {}
    for shard in shards:
        sd.update(read_safetensors(os.path.join(path, shard)))
    return sd


def load_llama_from_hf(src: Any, *,
                       config_overrides: Optional[Dict[str, Any]] = None,
                       quantize: bool = False, device: DeviceLike = None):
    """One-call import: ``src`` is a live model (``.state_dict()`` and
    ``.config``), a (state_dict, config) pair, or a checkpoint directory
    holding ``config.json`` + ``*.safetensors``.  Returns (params, cfg)
    on ``device`` (default: the card); ``quantize=True`` converts weight
    matrices to int8 w8a16 (models/quant.py) for serving."""
    overrides = config_overrides or {}
    if isinstance(src, str):
        with open(os.path.join(src, "config.json")) as f:
            hf_cfg = json.load(f)
        sd = _load_safetensors_dir(src)
    elif isinstance(src, tuple):
        sd, hf_cfg = src
    else:  # a live model
        sd = src.state_dict()
        hf_cfg = src.config
    cfg = llama_config_from_hf(hf_cfg, **overrides)
    params = params_from_hf_state_dict(sd, cfg, quantize=quantize,
                                       device=device)
    return params, cfg
