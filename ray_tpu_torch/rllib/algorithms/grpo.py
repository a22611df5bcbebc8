"""GRPO — Group Relative Policy Optimization for LLM RLHF (port of
``ray_tpu/rllib/algorithms/grpo.py``).

Each iteration samples G completions for each of ``num_prompts`` prompts
with the current policy (a Llama, ``models/llama.py``), scores them
with ``reward_fn``, normalises the rewards within each prompt's group
(A_i = (r_i - mean) / (std + 1e-6)) and takes ``num_epochs`` clipped
importance-ratio steps with a k3 KL penalty against the frozen initial
policy — the JAX package's iteration, as eager PyTorch on one device.

Sampling is the reference's design: a full-buffer forward per new token
(the causal mask makes the unwritten tail irrelevant), no KV cache.  On
the card, at S >= 256 with S a multiple of min(512, S), attention is the
flash kernel K9f, and the loss's backward runs K10 and K11
(``ops/flash_attention.py``).  Only the positions that are read reach
the head projection: the hidden states of the completion region (and,
while sampling, of the one position a step reads) are sliced before the
[d, V] product, so the [B, S, V] logits never exist.

Sampling draws Gumbel noise and takes ``argmax(logits / T + g)``, which
is what ``jax.random.categorical`` computes.  The noise is a
counter-based hash of (seed, row, step, token) in integer tensor ops
(``gumbel_noise``): each row's stream depends only on its row and the
iteration's seed, and it is the same on the CPU and on the card.  A test
passes JAX's own draws instead (``noise=``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import torch

from ray_tpu_torch.models import llama
from ray_tpu_torch.rllib.algorithm import (
    Algorithm,
    AlgorithmConfig,
    scalars,
    to_device,
    to_host,
)
from ray_tpu_torch.rllib.learner import (
    Learner,
    LearnerSpec,
    adam,
    dp_mesh,
    trainable,
)


class GRPOConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.env = None  # no simulator: the reward function is the env
        # model
        self.model = llama.LLAMA_TINY
        # sampling
        self.num_prompts = 4       # distinct prompts per iteration
        self.group_size = 8        # G samples per prompt
        self.prompt_len = 8
        self.max_new_tokens = 16
        self.temperature = 1.0
        # optimization
        self.lr = 3e-4
        self.num_epochs = 2
        self.clip_param = 0.2
        self.kl_coef = 0.02
        self.grad_clip = 1.0
        # More than one learner (the JAX package's dp mesh) is not
        # ported: num_learners > 1 raises NotImplementedError.
        self.num_learners = 1
        # reward_fn(prompt_tokens (B,P) int, completion (B,N) int) -> (B,)
        # float tensor on the algorithm's device.
        self.reward_fn: Optional[Callable] = None
        # prompt_source(generator) -> (num_prompts, prompt_len) int tensor
        # (the algorithm's CPU generator); defaults to uniform random
        # tokens.
        self.prompt_source: Optional[Callable] = None

    @property
    def algo_class(self):
        return GRPO


@dataclasses.dataclass(frozen=True)
class _Static:
    prompt_len: int
    max_new: int
    group: int
    num_prompts: int
    temperature: float
    clip: float
    kl_coef: float
    num_epochs: int


def _static(cfg: GRPOConfig) -> _Static:
    return _Static(cfg.prompt_len, cfg.max_new_tokens, cfg.group_size,
                   cfg.num_prompts, cfg.temperature, cfg.clip_param,
                   cfg.kl_coef, cfg.num_epochs)


# --- noise --------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mix32(x):
    """A 32-bit integer mixer on values in [0, 2^32) (int64 tensors or
    Python ints): xor-shifts and multiplies by odd constants below 2^31,
    so no product leaves int64."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x2C1B3C6D) & _M32
    return x ^ (x >> 16)


def gumbel_noise(seed: int, rows: torch.Tensor, step: int,
                 vocab: int) -> torch.Tensor:
    """Standard Gumbel draws [len(rows), vocab] (float32, on ``rows``'
    device), a function of (seed, row, step, token) only: 24 hashed bits
    u in (0, 1), then -log(-log u) in float64."""
    base = _mix32(_mix32(seed & _M32) ^ (step & _M32))
    r = _mix32((rows.to(torch.int64) + base) & _M32)[:, None]
    v = torch.arange(vocab, dtype=torch.int64, device=rows.device)[None, :]
    h = _mix32((_mix32(v ^ r) + r) & _M32)
    u = ((h >> 8).to(torch.float64) + 0.5) * 2.0 ** -24
    return (-torch.log(-torch.log(u))).to(torch.float32)


# --- the iteration ----------------------------------------------------------

def _logits_at(params, buf, mcfg, lo: int, hi: int) -> torch.Tensor:
    """Float32 logits of positions [lo, hi) of ``buf``: the backbone over
    the whole buffer, the head over those positions only."""
    x, head = llama.forward_hidden(params, buf, mcfg)
    return llama._head_matmul(x[:, lo:hi], head, mcfg).float()


def _completion_logps(params, buf, mcfg, P, N, temperature=1.0):
    """Per-token log-probs of the completion region under ``params``, at
    the sampler's temperature.  buf: (B, P+N) tokens; returns (B, N)
    float32."""
    pred = _logits_at(params, buf, mcfg, P - 1, P + N - 1) / temperature
    tgt = buf[:, P:P + N].long()
    logp = torch.log_softmax(pred, dim=-1)
    return torch.gather(logp, -1, tgt[..., None])[..., 0]


@torch.no_grad()
def _sample(params, prompts, mcfg, st: _Static, noise: Callable):
    """Autoregressive sampling: (B,P) prompts → ((B,P+N) buffer, (B,N)
    sampling-time logps), a full-buffer forward a step.  ``noise(t)``
    gives step t's Gumbel draws [B, V]."""
    B = prompts.shape[0]
    P, N = st.prompt_len, st.max_new
    buf = torch.cat([prompts, prompts.new_zeros((B, N))], dim=1)
    logps = []
    for t in range(N):
        step_logits = _logits_at(params, buf, mcfg, P - 1 + t,
                                 P + t)[:, 0] / st.temperature
        tok = torch.argmax(step_logits + noise(t), dim=-1)
        logps.append(torch.gather(torch.log_softmax(step_logits, dim=-1),
                                  -1, tok[:, None])[:, 0])
        buf[:, P + t] = tok.to(buf.dtype)
    return buf, torch.stack(logps, dim=1)


def _grpo_loss(params, buf, old_logps, ref_logps, adv, mcfg, st: _Static):
    cur = _completion_logps(params, buf, mcfg, st.prompt_len, st.max_new,
                            st.temperature)
    ratio = torch.exp(cur - old_logps)                     # (B, N)
    adv_t = adv[:, None]
    surrogate = torch.minimum(
        ratio * adv_t,
        torch.clamp(ratio, 1 - st.clip, 1 + st.clip) * adv_t,
    ).mean()
    # k3 KL estimator vs the frozen reference (unbiased, low-variance).
    log_r = ref_logps - cur
    kl = (torch.exp(log_r) - log_r - 1.0).mean()
    return -(surrogate - st.kl_coef * kl), {
        "kl": kl, "ratio_mean": ratio.mean(),
        "logp_gap": (cur - old_logps).abs().max(),
    }


def group_advantages(rewards: torch.Tensor, group: int) -> torch.Tensor:
    """(r - group mean) / (group std + 1e-6) within each prompt's group
    (std over the group, ddof 0)."""
    grp = rewards.reshape(-1, group)
    return ((grp - grp.mean(dim=1, keepdim=True))
            / (grp.std(dim=1, keepdim=True, correction=0) + 1e-6)
            ).reshape(-1)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _grpo_body(mcfg, learner, reward_fn, st: _Static, params, ref_params,
               opt_state, prompts, noise):
    """Sampling + reward + group advantages + SGD epochs for one batch;
    params and moments updated in place.  Returns (params, opt_state,
    metrics): the JAX package's (reward mean and max, the last epoch's
    loss and kl) and the first epoch's ``ratio_mean`` and ``logp_gap``
    (max |recomputed − sampled logp|), with ``sample_s``, the sampling's
    wall time."""
    t0 = time.perf_counter()
    buf, old_logps = _sample(params, prompts, mcfg, st, noise)
    _sync(prompts.device)
    sample_s = time.perf_counter() - t0
    completions = buf[:, st.prompt_len:]
    rewards = reward_fn(prompts, completions).to(torch.float32)
    adv = group_advantages(rewards, st.group)
    with torch.no_grad():
        ref_logps = _completion_logps(ref_params, buf, mcfg, st.prompt_len,
                                      st.max_new, st.temperature)
    batch = {"buf": buf, "old_logps": old_logps, "ref_logps": ref_logps,
             "adv": adv}
    epochs = []
    for _ in range(st.num_epochs):
        params, opt_state, m = learner.update_fn(params, opt_state, batch)
        epochs.append(m)
    metrics = {
        "reward_mean": rewards.mean(),
        "reward_max": rewards.max(),
        "loss": epochs[-1]["loss"],
        "kl": epochs[-1]["kl"],
        "ratio_mean": epochs[0]["ratio_mean"],
        "logp_gap": epochs[0]["logp_gap"],
        "sample_s": sample_s,
    }
    return params, opt_state, metrics


def _noise_fn(seed: int, rows: int, vocab: int, device) -> Callable:
    row_ids = torch.arange(rows, device=device)
    return lambda t: gumbel_noise(seed, row_ids, t, vocab)


def _grpo_iteration(mcfg, learner, reward_fn, prompt_source, st: _Static,
                    gen: torch.Generator, params, ref_params, opt_state,
                    device):
    """Prompts and the noise seed from the CPU generator ``gen`` (so a
    seed gives the same iteration on any device), then the body."""
    prompts = prompt_source(gen).to(device)                 # (n, P)
    prompts = torch.repeat_interleave(prompts, st.group, dim=0)
    seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=gen))
    noise = _noise_fn(seed, prompts.shape[0], mcfg.vocab_size, device)
    return _grpo_body(mcfg, learner, reward_fn, st, params, ref_params,
                      opt_state, prompts, noise)


class GRPO(Algorithm):
    config_class = GRPOConfig

    def _setup(self) -> None:
        cfg = self.config
        if cfg.reward_fn is None:
            raise ValueError("GRPOConfig.reward_fn is required (the "
                             "reward model IS the environment in RLHF)")
        if cfg.num_learners > 1:
            dp_mesh(cfg.num_learners)  # raises: not ported
        mcfg = cfg.model
        init_gen = torch.Generator(device=self.device).manual_seed(
            int(cfg.seed))
        self.params = trainable(llama.init_params(init_gen, mcfg,
                                                  device=self.device))
        # Frozen reference policy for the KL penalty (the init
        # checkpoint); a copy, since the update runs in place.
        self.ref_params = to_device(self.params, self.device)
        self.tx = adam(cfg.lr, cfg.grad_clip)
        self.opt_state = self.tx.init(self.params)
        st = _static(cfg)
        self._st = st
        self._prompt_source = cfg.prompt_source or (
            lambda g: torch.randint(0, mcfg.vocab_size,
                                    (cfg.num_prompts, cfg.prompt_len),
                                    generator=g, dtype=torch.int32))
        self._learner = Learner(LearnerSpec(
            loss_fn=lambda p, b, rng: _grpo_loss(
                p, b["buf"], b["old_logps"], b["ref_logps"], b["adv"],
                mcfg, st),
            optimizer=self.tx))

    def _train_once(self) -> Dict[str, Any]:
        cfg = self.config
        self.params, self.opt_state, metrics = _grpo_iteration(
            cfg.model, self._learner, cfg.reward_fn, self._prompt_source,
            self._st, self._gen, self.params, self.ref_params,
            self.opt_state, self.device)
        out = scalars(metrics)
        out["_timesteps"] = (cfg.num_prompts * cfg.group_size
                             * cfg.max_new_tokens)
        return out

    def sample(self, prompts, seed: int = 0) -> torch.Tensor:
        """Temperature sampling with the current policy (noise from
        ``seed``): the (B, max_new_tokens) completions."""
        cfg = self.config
        prompts = torch.as_tensor(prompts, device=self.device)
        if prompts.shape[1] != cfg.prompt_len:
            raise ValueError(
                f"prompts width {prompts.shape[1]} != config.prompt_len "
                f"{cfg.prompt_len} — _sample indexes by prompt_len")
        noise = _noise_fn(seed, prompts.shape[0], cfg.model.vocab_size,
                          self.device)
        buf, _ = _sample(self.params, prompts, cfg.model, self._st, noise)
        return buf[:, cfg.prompt_len:]

    def get_state(self) -> Dict[str, Any]:
        return {
            "params": to_host(self.params),
            "ref_params": to_host(self.ref_params),
            "opt_state": to_host(self.opt_state),
            "iteration": self.iteration,
        }

    def set_state(self, state: Dict[str, Any]) -> None:
        self.params = to_device(state["params"], self.device, grad=True)
        self.ref_params = to_device(state["ref_params"], self.device)
        self.opt_state = to_device(state["opt_state"], self.device)
        self.iteration = state.get("iteration", 0)
