"""Vision Transformer (ViT) for training (port of ``ray_tpu/models/vit.py``).

Plain functions on tensors, as in the JAX package: parameters are a
nested dict with the JAX package's key names and stacked layouts
(``patch_embed [P,d]``, ``pos_embed [S,d]``, ``layers.wqkv
[L,d,3,H,hd]``, ``wo [L,H,hd,d]``, ``w1 [L,d,m]``, ``w2 [L,m,d]``,
``ln*_scale/bias [L,d]``, ``head_w [d,classes]``), so
``bridge.params_from_jax`` is a pure copy.

Patch embedding is one reshape/permute and a product; each encoder
block is pre-norm attention and a GELU MLP, with products in
``cfg.dtype`` and layer norm in f32.  Two reference behaviours carry
over: ``layer_norm`` takes the population variance (ddof 0), and the
GELU is the tanh approximation (``jax.nn.gelu``'s default).  Attention
is non-causal at S 197, so it takes ``ops.attention``'s einsum path in
both packages: ViT launches no kernel.  ``encode`` rematerialises every
block when ``cfg.remat`` and gradients are on (the JAX
``jax.checkpoint`` with no policy).  The head starts at zero, as in the
JAX package, so on the first step every backbone gradient is 0.  Over
ranks ``loss_fn`` declares the ``"rows"`` split (a mean over rows), so
the data-parallel step trains the global batch's mean.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.models.llama import _layers
from ray_tpu_torch.ops.attention import dot_product_attention
from ray_tpu_torch.parallel import loss_split

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    channels: int = 3
    dim: int = 1024
    n_layers: int = 24
    n_heads: int = 16
    mlp_dim: int = 4096
    num_classes: int = 1000
    pooling: str = "cls"  # "cls" | "gap"
    norm_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = True

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def patch_dim(self) -> int:
        return self.patch_size * self.patch_size * self.channels

    @property
    def seq_len(self) -> int:
        return self.n_patches + (1 if self.pooling == "cls" else 0)

    def num_params(self) -> int:
        per_layer = 4 * self.dim * self.dim + 2 * self.dim * self.mlp_dim \
            + 4 * self.dim + self.mlp_dim + self.dim
        cls = self.dim if self.pooling == "cls" else 0
        emb = self.patch_dim * self.dim + self.seq_len * self.dim + cls
        head = self.dim * self.num_classes + self.num_classes
        return self.n_layers * per_layer + emb + head + 2 * self.dim


# Canonical configs (ViT-B/L per the original paper's table 1).
VIT_B16 = ViTConfig(dim=768, n_layers=12, n_heads=12, mlp_dim=3072)
VIT_L16 = ViTConfig()
VIT_TINY = ViTConfig(image_size=32, patch_size=8, dim=64, n_layers=2,
                     n_heads=4, mlp_dim=128, num_classes=10, remat=False)

CONFIGS = {"vit-b16": VIT_B16, "vit-l16": VIT_L16, "tiny": VIT_TINY}


def _layer_axes() -> Params:
    return {
        "ln1_scale": ("layers", "embed"), "ln1_bias": ("layers", "embed"),
        "ln2_scale": ("layers", "embed"), "ln2_bias": ("layers", "embed"),
        "wqkv": ("layers", "embed", "qkv", "heads", "head_dim"),
        "wo": ("layers", "heads", "head_dim", "embed"),
        "w1": ("layers", "embed", "mlp"),
        "b1": ("layers", "mlp"),
        "w2": ("layers", "mlp", "embed"),
        "b2": ("layers", "embed"),
    }


def logical_axes(cfg: ViTConfig) -> Params:
    """The JAX package's logical axis names per leaf, which lay the
    params out over a mesh (``TorchTrainer(params_axes=...)``; the rule
    table needs entries for "patch" and "classes", as the JAX one
    does)."""
    out = {
        "patch_embed": ("patch", "embed"),
        "pos_embed": ("seq", "embed"),
        "layers": _layer_axes(),
        "ln_f_scale": ("embed",), "ln_f_bias": ("embed",),
        "head_w": ("embed", "classes"), "head_b": ("classes",),
    }
    if cfg.pooling == "cls":
        out["cls_token"] = ("embed",)
    return out


def trunc_normal(generator: torch.Generator, shape, fan_in: int,
                 device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """A standard normal truncated to [-2, 2] (``jax.random.
    truncated_normal(key, -2, 2)``), times fan_in^-0.5."""
    t = torch.empty(shape, device=device, dtype=dtype)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(fan_in ** -0.5)


def encoder_layers(generator: torch.Generator, L: int, D: int, H: int,
                   M: int, device: torch.device,
                   dtype: torch.dtype) -> Params:
    """One stack of pre-norm blocks (ViT's and CLIP's text tower's)."""
    hd = D // H

    def ones(*shape):
        return torch.ones(shape, device=device, dtype=dtype)

    def zeros(*shape):
        return torch.zeros(shape, device=device, dtype=dtype)

    return {
        "ln1_scale": ones(L, D), "ln1_bias": zeros(L, D),
        "ln2_scale": ones(L, D), "ln2_bias": zeros(L, D),
        "wqkv": trunc_normal(generator, (L, D, 3, H, hd), D, device, dtype),
        "wo": trunc_normal(generator, (L, H, hd, D), D, device, dtype),
        "w1": trunc_normal(generator, (L, D, M), D, device, dtype),
        "b1": zeros(L, M),
        "w2": trunc_normal(generator, (L, M, D), M, device, dtype),
        "b2": zeros(L, D),
    }


def init_params(generator: torch.Generator, cfg: ViTConfig,
                device: DeviceLike = None,
                dtype: Optional[torch.dtype] = None) -> Params:
    """Random init from ``generator`` (on ``device``) into ``dtype``
    (default ``cfg.param_dtype``): the JAX package's tree and scaling
    (truncated normal * fan_in^-0.5, norms at one, biases and the head
    at zero); the draws differ."""
    dev = resolve_device(device)
    dt = dtype or cfg.param_dtype
    D = cfg.dim
    params: Params = {
        "patch_embed": trunc_normal(generator, (cfg.patch_dim, D),
                                    cfg.patch_dim, dev, dt),
        "pos_embed": trunc_normal(generator, (cfg.seq_len, D), D, dev, dt),
        "layers": encoder_layers(generator, cfg.n_layers, D, cfg.n_heads,
                                 cfg.mlp_dim, dev, dt),
        "ln_f_scale": torch.ones((D,), device=dev, dtype=dt),
        "ln_f_bias": torch.zeros((D,), device=dev, dtype=dt),
        "head_w": torch.zeros((D, cfg.num_classes), device=dev, dtype=dt),
        "head_b": torch.zeros((cfg.num_classes,), device=dev, dtype=dt),
    }
    if cfg.pooling == "cls":
        params["cls_token"] = trunc_normal(generator, (D,), D, dev, dt)
    return params


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """Layer norm in f32 over the last axis, population variance."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    out = (x32 - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()
    return out.to(x.dtype)


def patchify(images: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """(B, H, W, C) → (B, N, patch_dim), patches row-major, each patch
    (p, p, C) flattened."""
    B, H, W, C = images.shape
    p = cfg.patch_size
    x = images.reshape(B, H // p, p, W // p, p, C)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, (H // p) * (W // p), p * p * C)


def encoder_block(x: torch.Tensor, layer: Params, n_heads: int, eps: float,
                  dt: torch.dtype, causal: bool) -> torch.Tensor:
    """One pre-norm block: attention, then a tanh-GELU MLP (ViT's
    ``_layer_fn``, CLIP's ``_text_layer``)."""
    B, S, D = x.shape
    h = layer_norm(x, layer["ln1_scale"], layer["ln1_bias"], eps)
    wqkv = layer["wqkv"]
    qkv = (h.to(dt) @ wqkv.to(dt).reshape(D, -1)).reshape(
        B, S, *wqkv.shape[1:])
    attn = dot_product_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                                 causal=causal)
    wo = layer["wo"]
    attn = attn.to(dt).reshape(B, S, -1) @ wo.to(dt).reshape(-1, D)
    x = x + attn.to(x.dtype)

    h = layer_norm(x, layer["ln2_scale"], layer["ln2_bias"], eps)
    h = h.to(dt) @ layer["w1"].to(dt) + layer["b1"].to(dt)
    h = F.gelu(h, approximate="tanh")
    h = h @ layer["w2"].to(dt) + layer["b2"].to(dt)
    return x + h.to(x.dtype)


def _layer_fn(cfg: ViTConfig, x: torch.Tensor, layer: Params) -> torch.Tensor:
    return encoder_block(x, layer, cfg.n_heads, cfg.norm_eps, cfg.dtype,
                         causal=False)


def encode(params: Params, images: torch.Tensor, cfg: ViTConfig
           ) -> torch.Tensor:
    """(B, H, W, C) images → (B, D) pooled features (pre-head)."""
    dt = cfg.dtype
    x = patchify(images.to(dt), cfg) @ params["patch_embed"].to(dt)
    if cfg.pooling == "cls":
        cls = params["cls_token"].to(dt).expand(x.shape[0], 1, cfg.dim)
        x = torch.cat([cls, x], dim=1)
    x = x + params["pos_embed"].to(dt)[None]
    remat = cfg.remat and torch.is_grad_enabled()
    for layer in _layers(params["layers"], cfg.n_layers):
        if remat:
            x = checkpoint(_layer_fn, cfg, x, layer, use_reentrant=False)
        else:
            x = _layer_fn(cfg, x, layer)
    x = layer_norm(x, params["ln_f_scale"], params["ln_f_bias"],
                   cfg.norm_eps)
    if cfg.pooling == "cls":
        return x[:, 0]
    return x.mean(dim=1)


def forward(params: Params, images: torch.Tensor, cfg: ViTConfig
            ) -> torch.Tensor:
    """Images → class logits (float32)."""
    feats = encode(params, images, cfg)
    return feats.float() @ params["head_w"].float() \
        + params["head_b"].float()


def loss_fn(params: Params, images: torch.Tensor, labels: torch.Tensor,
            cfg: ViTConfig) -> torch.Tensor:
    """Mean softmax cross-entropy of the class logits.  A mean over the
    batch's rows: it declares the ``"rows"`` split, and the data-parallel
    step weights each member's loss by its share of the global rows
    (``parallel/loss_split.py``)."""
    loss_split.declare("rows")
    logp = torch.log_softmax(forward(params, images, cfg), dim=-1)
    return -logp.gather(-1, labels.long()[:, None]).mean()
