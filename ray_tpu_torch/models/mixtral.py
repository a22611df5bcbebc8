"""Mixtral-family sparse-MoE transformer for training (port of
``ray_tpu/models/mixtral.py``).

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
``"full"`` keeps nothing.

Over ranks (``TorchTrainer`` on a ``torch.distributed`` group) the loss
is computed over the global batch, as GSPMD computes the JAX one:
``loss_fn`` declares the ``"global"`` split and ``moe_block`` reads the
step's data group (``parallel/loss_split.py``) for the global capacity,
buffer positions and aux loss.  On a mesh with ``ep`` > 1 each rank
holds E/ep experts (``logical_axes``'s "expert" axis) and the block sums
the experts' outputs over ``ep``.  ``ops/moe_a2a.py`` is the explicit
per-device-capacity dispatch over ``ep``, a standalone op.
``sequence_parallel`` is multi-device and raises NotImplementedError
(ROADMAP item 7).
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
from ray_tpu_torch.parallel import collectives as coll
from ray_tpu_torch.parallel import loss_split

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
    """The JAX package's logical axis names per leaf, which lay the params
    out over a mesh (``TorchTrainer(params_axes=...)``): the experts'
    and the router's E axis over ``ep`` at rest (``moe_block`` gathers
    the router)."""
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


def _route(xf: torch.Tensor, moe: Params, cfg: MixtralConfig, C: int,
           group: Optional[loss_split.DataGroup] = None):
    """Shared routing math: top-k experts + capacity-bounded buffer
    positions.  Returns (topk_idx [G,k], gate [G*k], pos [G*k] int64,
    keep [G*k], probs [G,E], oh [G,k,E]).

    With ``group`` (the data members of a step over the global batch)
    the positions are global: each assignment's token-major rank among
    this member's rows plus the assignments to its expert in the earlier
    members' rows, from one all-gather of the [E] counts; the gathered
    [n, E] counts come back as a seventh value."""
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
    counts = None
    if group is not None:
        counts = group.gather(flat.sum(dim=0))                   # [n, E]
        pos = pos + counts[:group.index].sum(dim=0)
    pos = (pos * flat).sum(dim=-1)                               # [G*k]
    keep = (pos < C).float()
    gate = topk_probs.reshape(G * k) * keep
    out = (topk_idx, gate, pos.long(), keep, probs, oh)
    return out if counts is None else out + (counts,)


def _expert_ffn(expert_in: torch.Tensor, moe: Params,
                dt: torch.dtype) -> torch.Tensor:
    """[E, C, D] → [E, C, D]: all expert FFNs as batched products."""
    g = torch.matmul(expert_in, moe["w_gate"].to(dt))
    u = torch.matmul(expert_in, moe["w_up"].to(dt))
    return torch.matmul(F.silu(g) * u, moe["w_down"].to(dt))


def _scatter(xf, eidx, pos, mine, C: int, E: int, dt) -> torch.Tensor:
    """The [E, C, D] expert buffers: assignment i (of token i // k of
    ``xf`` [G, D]) added at row ``pos[i]`` of expert ``eidx[i]`` where
    ``mine``, the others into a spare row past the buffers that is cut
    off (the JAX scatter's ``mode="drop"``)."""
    G, D = xf.shape
    row = torch.where(mine, eidx * C + pos, torch.full_like(pos, E * C))
    xk = xf.repeat_interleave(eidx.numel() // G, dim=0).to(dt)  # [G*k, D]
    buf = torch.zeros((E * C + 1, D), dtype=dt, device=xf.device)
    return buf.index_add(0, row, xk)[:E * C].reshape(E, C, D)


def _combine(out, eidx, pos, mine, gate, k: int) -> torch.Tensor:
    """[G, D]: each assignment's row of ``out`` [E, C, D] times its gate,
    summed over its token's k slots.  The JAX gather clamps a dropped
    assignment's position (>= C) to C - 1 in expert min(E, E - 1); so
    one not ``mine`` reads a clamped row, and its gate is 0."""
    E, C, D = out.shape
    got = out[torch.where(mine, eidx, E - 1), pos.clamp(max=C - 1)]
    return (got * gate[:, None].to(out.dtype)).reshape(-1, k, D).sum(dim=1)


def _experts(xf, moe, cfg, topk_idx, gate, pos, keep, oh, C, e0, El):
    """The MoE output [G, D] of experts [e0, e0 + El) (``moe``'s expert
    leaves hold just those): ``"scatter"`` adds the kept assignments
    into their buffer rows and gathers them back (``_scatter``,
    ``_combine``); ``"dense"`` builds the [G, El, C] dispatch and
    combine tensors."""
    G, D = xf.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    dt = cfg.dtype
    if cfg.dispatch_mode == "scatter":
        mine = keep > 0
        eidx = topk_idx.reshape(G * k) - e0
        if El < E:
            mine = mine & (eidx >= 0) & (eidx < El)
            gate = gate * mine
        expert_out = _expert_ffn(_scatter(xf, eidx, pos, mine, C, El, dt),
                                 moe, dt)
        return _combine(expert_out, eidx, pos, mine, gate, k)
    flat = oh.reshape(G * k, E)
    pos_oh = (pos[:, None] == torch.arange(C, device=xf.device)
              ).float()                                          # [G*k, C]
    assign = flat[:, :, None] * pos_oh[:, None, :]               # [G*k,E,C]
    if El < E:
        assign = assign[:, e0:e0 + El]
    dispatch = (assign * keep[:, None, None]).reshape(
        G, k, El, C).sum(dim=1)
    combine = (assign * gate[:, None, None]).reshape(
        G, k, El, C).sum(dim=1)
    # "gec,gd->ecd" and "gec,ecd->gd" as 2-D products (``mm``).
    expert_in = (dispatch.to(dt).reshape(G, El * C).T
                 @ xf.to(dt)).reshape(El, C, D)
    expert_out = _expert_ffn(expert_in, moe, dt)
    return combine.to(dt).reshape(G, El * C) @ expert_out.reshape(El * C, D)


def moe_block(x: torch.Tensor, moe: Params, cfg: MixtralConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, D] → (out [B, S, D], aux_loss scalar).

    Dropped assignments (over capacity) add nothing: the residual carries
    their tokens (Switch behaviour).  ``"dense"`` builds the [G, E, C]
    dispatch and combine tensors; ``"scatter"`` adds the kept assignments
    into their [E, C, D] buffer rows (the dropped ones into a spare row
    past the buffers, then cut off, as ``mode="drop"`` discards them) and
    gathers each assignment's output back.

    Inside the data-parallel step over n > 1 data members
    (``loss_split.current()``) the block computes its share of the
    global batch's: C from the global token count, global buffer
    positions (``_route``), ``frac`` from the members' counts and
    ``mean_prob`` as this member's sum of ``probs`` over the global
    token count, so the members' aux values sum to the global one.  The
    buffers stay [E, C, D] with this member's rows filled; the expert
    FFN is row by row, so no exchange is needed.  With the experts
    sharded over ``ep`` (``moe``'s leaves hold this rank's E/ep experts
    and router columns, as ``logical_axes`` lays them out at rest) the
    router is gathered whole (``gather_from``: every ``ep`` rank routes
    the same rows, so each keeps its columns' grads), each rank runs its
    experts on its rows' buffers and the partial outputs are summed over
    ``ep`` (``reduce_from``), the rows and gates entering through
    ``copy_to`` so that the router and the layers below get whole grads:
    the single-device block's value, capacity global."""
    B, S, D = x.shape
    E = cfg.n_experts
    G = B * S
    group = loss_split.current()
    dp = group if group is not None and group.n > 1 else None
    C = capacity(cfg, G * (dp.n if dp else 1))
    xf = x.reshape(G, D)
    ep = group.ep if group is not None else 1
    El = E // ep
    if ep > 1:
        held = (moe["w_gate"].shape[0], moe["w_router"].shape[-1])
        if held != (El, El):
            raise ValueError(
                f"expert parallelism over ep={ep}: this rank's expert "
                f"leaves and router hold {held} experts, want {El} of {E}")
        mesh = group.mesh
        moe = dict(moe, w_router=coll.gather_from(
            moe["w_router"], "ep", mesh=mesh, tiled_axis=-1))
    routed = _route(xf, moe, cfg, C, dp)
    topk_idx, gate, pos, keep, probs, oh = routed[:6]
    if ep == 1:
        y = _experts(xf, moe, cfg, topk_idx, gate, pos, keep, oh, C, 0, E)
    else:
        y = coll.reduce_from(_experts(
            coll.copy_to(xf, "ep", mesh=mesh), moe, cfg, topk_idx,
            coll.copy_to(gate, "ep", mesh=mesh), pos, keep, oh, C,
            group.ep_index * El, El), "ep", mesh=mesh)

    # Switch load-balance loss: E * Σ_e fraction_dispatched_e · mean_prob_e.
    if dp is None:
        frac = oh.sum(dim=1).mean(dim=0)                         # [E]
        mean_prob = probs.mean(dim=0)                            # [E]
    else:
        frac = routed[6].sum(dim=0) / (G * dp.n)
        mean_prob = probs.sum(dim=0) / (G * dp.n)
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
    """Next-token cross-entropy + ``router_aux_coef`` x router aux loss.

    It declares the ``"global"`` split (``parallel/loss_split.py``):
    inside the data-parallel step over n > 1 members it returns this
    member's share of the global batch's loss (the cross-entropy as its
    masked sum over the global token count, the aux as ``moe_block``'s
    share) and of each aux value (``ntokens`` this member's count), so
    that the members' values sum to JAX's global ones."""
    group = loss_split.declare("global")
    tokens = batch["tokens"]
    logits, aux = forward(params, tokens, cfg,
                          segment_ids=batch.get("segment_ids"))
    ce, ntokens = llama.next_token_loss(logits, tokens,
                                        batch.get("loss_mask"),
                                        z_loss=z_loss)
    if group is not None and group.n > 1:
        ce = ce * (ntokens / group.total(ntokens).clamp_min(1.0))
    total = ce + cfg.router_aux_coef * aux
    return total, {"loss": total, "ce_loss": ce, "aux_loss": aux,
                   "ntokens": ntokens}
