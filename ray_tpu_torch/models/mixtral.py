"""Mixtral-family sparse-MoE transformer for training (port of
``ray_tpu/models/mixtral.py``), on one device.

Plain functions on tensors, as in the JAX package: parameters are a
nested dict with the JAX package's key names and stacked layouts
(``attn.wq [L,d,H,hd]``, ``wk/wv [L,d,KVH,hd]``, ``wo [L,H,hd,d]``;
``moe.w_router [L,d,E]``, ``w_gate/w_up [L,E,d,m]``, ``w_down
[L,E,m,d]``; ``ln_* [L,d]``, ``tok_embed [V,d]``, ``lm_head [d,V]``), so
``bridge.params_from_jax`` is a pure copy.

Attention is the port's Llama block (``llama._attn_block`` under a
``LlamaConfig`` built from the Mixtral fields): K9f forward and K10 +
K11 backward on the card at S >= 256.  The MoE layer is the GShard /
Switch capacity formulation in plain PyTorch, as the JAX package
computes it outside any Pallas kernel: f32 router, top-k with ties
toward the lower expert, renormalised gates, per-expert buffers of
static capacity C filled token-major (earlier tokens win capacity), the
expert FFNs as one batched ``[E, C, D] x [E, D, M]`` product, and a
Switch load-balance aux loss over every top-k assignment, dropped or
not.  ``dispatch_mode="dense"`` dispatches and combines through one-hot
``[G, E, C]`` tensors, written as 2-D products (``mm``) as the JAX
einsums are dots without batch dims; ``"scatter"`` adds each kept
assignment into its buffer row and gathers it back.  Dropped
assignments read a clamped row whose gate is 0, as the JAX gather
clamps its out-of-bounds index.

Under ``cfg.remat`` each layer runs under ``torch.utils.checkpoint``:
``"dots"`` keeps the 2-D products (projections, router, dispatch and
combine) and recomputes the rest, the batched expert products and the
flash forward included, as ``dots_with_no_batch_dims_saveable`` does;
``"full"`` keeps nothing.  Expert parallelism (``ops/moe_a2a.py``) and
``sequence_parallel`` are multi-device and raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch._device import DeviceLike, resolve_device
from ray_tpu_torch.models import llama
from ray_tpu_torch.models.llama import rms_norm

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class MixtralConfig:
    vocab_size: int = 32_000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    mlp_dim: int = 14_336
    n_experts: int = 8
    experts_per_token: int = 2
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.02
    # "dense" (one-hot dispatch/combine products) or "scatter"
    # (capacity-bounded scatter-add and gather; see moe_block).
    dispatch_mode: str = "dense"
    max_seq_len: int = 8192
    rope_theta: float = 1_000_000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = True
    remat_policy: str = "dots"
    logits_soft_cap: Optional[float] = None
    tie_embeddings: bool = False
    sequence_parallel: bool = False

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    def _attn_params(self) -> int:
        d, h = self.dim, self.head_dim
        return (d * self.n_heads * h + 2 * d * self.n_kv_heads * h
                + self.n_heads * h * d)

    def _emb_params(self) -> int:
        return self.vocab_size * self.dim * (1 if self.tie_embeddings else 2)

    def num_params(self) -> int:
        d = self.dim
        moe = d * self.n_experts + 3 * self.n_experts * d * self.mlp_dim
        per_layer = self._attn_params() + moe + 2 * d
        return self.n_layers * per_layer + self._emb_params() + d

    def active_params(self) -> int:
        """Params touched per token (the MoE selling point)."""
        d = self.dim
        moe = d * self.n_experts \
            + 3 * self.experts_per_token * d * self.mlp_dim
        return (self.n_layers * (self._attn_params() + moe + 2 * d)
                + self._emb_params() + d)


MIXTRAL_8X7B = MixtralConfig()
MIXTRAL_TINY = MixtralConfig(
    vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, mlp_dim=128,
    n_experts=4, experts_per_token=2, max_seq_len=128, remat=False,
)

CONFIGS = {"mixtral-8x7b": MIXTRAL_8X7B, "tiny": MIXTRAL_TINY}


def _unported(cfg: MixtralConfig) -> None:
    if cfg.sequence_parallel:
        raise NotImplementedError(
            "MixtralConfig.sequence_parallel: ring/Ulysses attention is "
            "multi-device and not ported to ray_tpu_torch yet (ROADMAP.md "
            "queue 1 item 7, sequence and pipeline parallel)")


# --- params ---------------------------------------------------------------

def logical_axes(cfg: MixtralConfig) -> Params:
    """The JAX package's logical axis names per leaf, kept as data: the
    port trains on one device and does not shard by them."""
    layer = {
        "attn": {
            "wq": ("layers", "embed", "heads", "head_dim"),
            "wk": ("layers", "embed", "kv_heads", "head_dim"),
            "wv": ("layers", "embed", "kv_heads", "head_dim"),
            "wo": ("layers", "heads", "head_dim", "embed"),
        },
        "moe": {
            "w_router": ("layers", "embed", "expert"),
            "w_gate": ("layers", "expert", "embed", "mlp"),
            "w_up": ("layers", "expert", "embed", "mlp"),
            "w_down": ("layers", "expert", "mlp", "embed"),
        },
        "ln_attn": ("layers", "embed"),
        "ln_mlp": ("layers", "embed"),
    }
    out: Params = {
        "tok_embed": ("vocab", "embed"),
        "layers": layer,
        "final_norm": ("embed",),
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = ("embed", "vocab")
    return out


def init_params(generator: torch.Generator, cfg: MixtralConfig,
                device: DeviceLike = None,
                dtype: Optional[torch.dtype] = None) -> Params:
    """Random init from ``generator`` (on ``device``) straight into
    ``dtype`` (default ``cfg.param_dtype``), each stacked leaf drawn one
    layer slice at a time in place: no temporary beside the tree.  Same
    tree and scaling as the JAX package (normal * fan_in^-0.5, norms at
    one); the draws differ."""
    dev = resolve_device(device)
    dt = dtype or cfg.param_dtype
    d, h, kvh, hd = cfg.dim, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    m, E, L = cfg.mlp_dim, cfg.n_experts, cfg.n_layers

    def normal(shape, fan_in):
        t = torch.empty(shape, device=dev, dtype=dt)
        return t.normal_(generator=generator).mul_(fan_in ** -0.5)

    stacked = {
        "attn": {"wq": ((d, h, hd), d), "wk": ((d, kvh, hd), d),
                 "wv": ((d, kvh, hd), d), "wo": ((h, hd, d), h * hd)},
        "moe": {"w_router": ((d, E), d), "w_gate": ((E, d, m), d),
                "w_up": ((E, d, m), d), "w_down": ((E, m, d), m)},
    }
    layers: Params = {
        group: {k: torch.empty((L,) + shape, device=dev, dtype=dt)
                for k, (shape, _) in leaves.items()}
        for group, leaves in stacked.items()}
    tok_embed = normal((cfg.vocab_size, d), d)
    for i in range(L):
        for group, leaves in stacked.items():
            for k, (_, fan_in) in leaves.items():
                layers[group][k][i].normal_(generator=generator).mul_(
                    fan_in ** -0.5)
    layers["ln_attn"] = torch.ones((L, d), device=dev, dtype=dt)
    layers["ln_mlp"] = torch.ones((L, d), device=dev, dtype=dt)
    params: Params = {"tok_embed": tok_embed, "layers": layers,
                      "final_norm": torch.ones((d,), device=dev, dtype=dt)}
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((d, cfg.vocab_size), d)
    return params


# --- MoE block ------------------------------------------------------------

def capacity(cfg: MixtralConfig, num_tokens: int) -> int:
    """Static per-expert buffer size."""
    c = int(cfg.capacity_factor * num_tokens * cfg.experts_per_token
            / cfg.n_experts)
    return max(c, cfg.experts_per_token)


def _route(xf: torch.Tensor, moe: Params, cfg: MixtralConfig, C: int):
    """Shared routing math: top-k experts + capacity-bounded buffer
    positions.  Returns (topk_idx [G,k], gate [G*k], pos [G*k] int64,
    keep [G*k], probs [G,E], oh [G,k,E])."""
    E, k = cfg.n_experts, cfg.experts_per_token
    G = xf.shape[0]
    logits = xf.float() @ moe["w_router"].float()
    probs = torch.softmax(logits, dim=-1)                        # [G, E]
    # lax.top_k: descending, ties toward the lower index (a stable sort).
    srt, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    topk_probs, topk_idx = srt[:, :k], order[:, :k]              # [G, k]
    topk_probs = topk_probs / topk_probs.sum(dim=-1, keepdim=True)
    # Position of each (token, slot) assignment in its expert's buffer:
    # flatten assignments token-major (earlier tokens win capacity).
    oh = F.one_hot(topk_idx, E).float()                          # [G, k, E]
    flat = oh.reshape(G * k, E)
    pos = torch.cumsum(flat, dim=0) - 1.0                        # [G*k, E]
    pos = (pos * flat).sum(dim=-1)                               # [G*k]
    keep = (pos < C).float()
    gate = topk_probs.reshape(G * k) * keep
    return topk_idx, gate, pos.long(), keep, probs, oh


def _expert_ffn(expert_in: torch.Tensor, moe: Params,
                dt: torch.dtype) -> torch.Tensor:
    """[E, C, D] → [E, C, D]: all expert FFNs as batched products."""
    g = torch.matmul(expert_in, moe["w_gate"].to(dt))
    u = torch.matmul(expert_in, moe["w_up"].to(dt))
    return torch.matmul(F.silu(g) * u, moe["w_down"].to(dt))


def moe_block(x: torch.Tensor, moe: Params, cfg: MixtralConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] → (out [B, S, D], aux_loss scalar).

    Dropped assignments (over capacity) add nothing: the residual carries
    their tokens (Switch behaviour).  ``"dense"`` builds the [G, E, C]
    dispatch and combine tensors; ``"scatter"`` adds the kept assignments
    into their [E, C, D] buffer rows (the dropped ones into a spare row
    past the buffers, then cut off, as ``mode="drop"`` discards them) and
    gathers each assignment's output back."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    G = B * S
    C = capacity(cfg, G)
    xf = x.reshape(G, D)
    topk_idx, gate, pos, keep, probs, oh = _route(xf, moe, cfg, C)
    dt = cfg.dtype

    if cfg.dispatch_mode == "scatter":
        kept = keep > 0
        eidx = topk_idx.reshape(G * k)
        row = torch.where(kept, eidx * C + pos,
                          torch.full_like(pos, E * C))
        xk = xf.repeat_interleave(k, dim=0).to(dt)               # [G*k, D]
        expert_in = torch.zeros((E * C + 1, D), dtype=dt, device=x.device)
        expert_in = expert_in.index_add(0, row, xk)[:E * C].reshape(E, C, D)
        expert_out = _expert_ffn(expert_in, moe, dt)
        # The JAX gather clamps a dropped assignment's position (>= C) to
        # C - 1 in expert min(E, E - 1); its gate is 0, so the row read
        # only has to exist.
        got = expert_out[torch.where(kept, eidx, E - 1),
                         pos.clamp(max=C - 1)]                   # [G*k, D]
        y = (got * gate[:, None].to(dt)).reshape(G, k, D).sum(dim=1)
    else:
        flat = oh.reshape(G * k, E)
        pos_oh = (pos[:, None] == torch.arange(C, device=x.device)
                  ).float()                                      # [G*k, C]
        assign = flat[:, :, None] * pos_oh[:, None, :]           # [G*k,E,C]
        dispatch = (assign * keep[:, None, None]).reshape(
            G, k, E, C).sum(dim=1)
        combine = (assign * gate[:, None, None]).reshape(
            G, k, E, C).sum(dim=1)
        # "gec,gd->ecd" and "gec,ecd->gd" as 2-D products (``mm``).
        expert_in = (dispatch.to(dt).reshape(G, E * C).T
                     @ xf.to(dt)).reshape(E, C, D)
        expert_out = _expert_ffn(expert_in, moe, dt)
        y = combine.to(dt).reshape(G, E * C) @ expert_out.reshape(E * C, D)

    # Switch load-balance loss: E * Σ_e fraction_dispatched_e · mean_prob_e.
    frac = oh.sum(dim=1).mean(dim=0)                             # [E]
    mean_prob = probs.mean(dim=0)                                # [E]
    aux = E * (frac * mean_prob).sum()
    return y.reshape(B, S, D), aux


# --- forward --------------------------------------------------------------

def _attn_cfg(cfg: MixtralConfig) -> llama.LlamaConfig:
    """The Llama config the attention block runs under: only the fields
    ``_qkv``/``_attn_block``/``rope_table`` read (no RoPE scaling, as the
    JAX ``rope_table`` finds none on a MixtralConfig)."""
    return llama.LlamaConfig(
        vocab_size=cfg.vocab_size, dim=cfg.dim, n_layers=cfg.n_layers,
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        mlp_dim=cfg.mlp_dim, max_seq_len=cfg.max_seq_len,
        rope_theta=cfg.rope_theta, norm_eps=cfg.norm_eps, dtype=cfg.dtype,
        param_dtype=cfg.param_dtype, remat=False,
        logits_soft_cap=cfg.logits_soft_cap)


def _layer_fn(cfg: MixtralConfig, acfg: llama.LlamaConfig, x, layer, sin,
              cos, segment_ids):
    h = x + llama._attn_block(rms_norm(x, layer["ln_attn"], cfg.norm_eps),
                              layer, acfg, sin, cos, segment_ids)[0]
    moe_out, aux = moe_block(rms_norm(h, layer["ln_mlp"], cfg.norm_eps),
                             layer["moe"], cfg)
    return h + moe_out, aux


def forward(
    params: Params,
    tokens: torch.Tensor,
    cfg: MixtralConfig,
    *,
    positions: Optional[torch.Tensor] = None,
    segment_ids: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] → (logits [B, S, V] float32, aux_loss scalar: the
    mean of the layers')."""
    _unported(cfg)
    if cfg.remat_policy not in ("dots", "full"):
        raise ValueError(
            f"remat_policy must be 'dots' or 'full', got {cfg.remat_policy!r}"
        )
    if positions is None:
        positions = torch.arange(tokens.shape[1],
                                 device=tokens.device).expand(tokens.shape)
    acfg = _attn_cfg(cfg)
    sin, cos = llama.rope_table(acfg, positions)
    x = params["tok_embed"][tokens.long()].to(cfg.dtype)
    remat = cfg.remat and torch.is_grad_enabled()
    kwargs = llama._remat_kwargs(cfg) if remat else {}
    auxes = []
    for layer in llama._layers(params["layers"], cfg.n_layers):
        if remat:
            x, aux = checkpoint(_layer_fn, cfg, acfg, x, layer, sin, cos,
                                segment_ids, use_reentrant=False, **kwargs)
        else:
            x, aux = _layer_fn(cfg, acfg, x, layer, sin, cos, segment_ids)
        auxes.append(aux)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["tok_embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ head.to(cfg.dtype)
    return logits.float(), torch.stack(auxes).mean()


def loss_fn(
    params: Params,
    batch: Dict[str, torch.Tensor],
    cfg: MixtralConfig,
    *,
    z_loss: float = 0.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy + ``router_aux_coef`` x router aux loss."""
    tokens = batch["tokens"]
    logits, aux = forward(params, tokens, cfg,
                          segment_ids=batch.get("segment_ids"))
    ce, ntokens = llama.next_token_loss(logits, tokens,
                                        batch.get("loss_mask"),
                                        z_loss=z_loss)
    total = ce + cfg.router_aux_coef * aux
    return total, {"loss": total, "ce_loss": ce, "aux_loss": aux,
                   "ntokens": ntokens}
