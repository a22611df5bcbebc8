"""The JAX tests' offline learning gates over seeds, on the CPU: how often
each passes, for the JAX package and for the port.

    JAX_PLATFORMS=cpu python scripts/offline_gate_sweep.py jax 0 1 2 3
    JAX_PLATFORMS=cpu python scripts/offline_gate_sweep.py port 0 1 2 3
    JAX_PLATFORMS=cpu python scripts/offline_gate_sweep.py port_pipeline 0 1

``jax``: the JAX tests' whole pipeline at seed s — a seed-s SAC, its
datasets (after 15 and 18 iterations, ``OfflineDataset.collect(seed=3)``),
BC, CQL and MARWIL at seed s.  ``port``: the port's BC, CQL and MARWIL
at seed s on the JAX tests' own datasets (``scripts/data``, written by
``make_offline_fixtures.py``).  ``port_pipeline``: the port's whole
pipeline at seed s on the CPU (its SAC logs the datasets from the JAX
tests' start states).  All score with the JAX tests' ``_rollout_return``
(the JAX env, its seed-11 start states) and gates
(tests/test_rllib_offline.py:72-97, tests/test_rllib_breadth2.py:135-165).
One JSON line a seed.
"""

import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ray_tpu import rllib as jrl  # noqa: E402
from ray_tpu.rllib.env import Pendulum  # noqa: E402


def rollout_return(act_fn, seed=11, episodes=3):
    """The JAX tests' ``_rollout_return``."""
    env, total, key = Pendulum(), 0.0, jax.random.key(seed)
    for _ in range(episodes):
        key, k = jax.random.split(key)
        state, obs = env.reset(k)
        done = False
        while not done:
            a = act_fn(np.array(obs))
            state, obs, r, d = env.step(state, jnp.asarray(a))
            total += float(r)
            done = bool(d)
    return total / episodes


def jax_datasets(seed):
    sac = (jrl.SACConfig().environment("Pendulum-v1")
           .training(steps_per_iteration=256, train_batch_size=128,
                     learning_starts=500).debugging(seed=seed).build())

    def behavior(obs, rng):
        a = sac.compute_single_action(obs)
        return np.clip(a + rng.normal(0, 0.35, a.shape), -2.0, 2.0
                       ).astype(np.float32)

    data = {}
    for it in range(1, 19):
        sac.train()
        if it in (15, 18):
            n = 3000 if it == 15 else 4000
            data[n] = jrl.OfflineDataset.collect(Pendulum(), behavior,
                                                 num_steps=n, seed=3)
    return data


def port_datasets(seed):
    """The port's seed-s SAC on the CPU and its datasets, the resets of
    JAX's ``collect(seed=3)`` key chain."""
    from ray_tpu_torch import rllib as trl
    from ray_tpu_torch.rllib.env import Pendulum as TPendulum

    key, resets = jax.random.key(3), []
    for _ in range(22):
        key, k = jax.random.split(key)
        k1, k2 = jax.random.split(k)
        resets.append([[float(jax.random.uniform(k1, ())),
                        float(jax.random.uniform(k2, ()))]])
    sac = (trl.SACConfig().training(steps_per_iteration=256,
                                    train_batch_size=128,
                                    learning_starts=500)
           .debugging(seed=seed).resources(device="cpu").build())

    def behavior(obs, rng):
        a = sac.compute_single_action(obs)
        return np.clip(a + rng.normal(0, 0.35, a.shape), -2.0, 2.0
                       ).astype(np.float32)

    data = {}
    for it in range(1, 19):
        sac.train()
        if it in (15, 18):
            n = 3000 if it == 15 else 4000
            data[n] = trl.OfflineDataset.collect(
                TPendulum(), behavior, num_steps=n, seed=3,
                reset_draws=np.array(resets, np.float32))
    return data


def fixture_datasets(rl):
    return {n: rl.OfflineDataset.load(os.path.join(
        HERE, "data", f"pendulum_sac{it}_{n}.npz"))
        for it, n in ((18, 4000), (15, 3000))}


def gates(rl, data, seed, device):
    def build(name, dataset, **kw):
        cfg = getattr(rl, name + "Config")().environment(
            "Pendulum-v1").training(**kw)
        cfg.dataset = dataset
        cfg = cfg.debugging(seed=seed)
        if device:
            cfg = cfg.resources(device=device)
        return cfg.build()

    out = {}
    bc = build("BC", data[4000])
    first = bc.train()["bc_loss"]
    for _ in range(25):
        last = bc.train()["bc_loss"]
    out["BC"] = rollout_return(bc.compute_single_action)
    out["BC_loss_halved"] = bool(last < 0.5 * first)
    cql = build("CQL", data[4000], cql_alpha=0.5)
    for _ in range(30):
        cql.train()
    out["CQL"] = rollout_return(cql.compute_single_action)
    marwil = build("MARWIL", data[3000], updates_per_iteration=64,
                   train_batch_size=256, beta=1.0)
    for _ in range(12):
        marwil.train()
    rng = np.random.default_rng(5)
    out["MARWIL_gate"] = rollout_return(
        lambda o: rng.uniform(-2.0, 2.0, (1,)).astype(np.float32)) + 500.0
    out["MARWIL"] = rollout_return(marwil.compute_single_action)
    out["pass"] = {"BC": out["BC"] > -700 and out["BC_loss_halved"],
                   "CQL": out["CQL"] > -700,
                   "MARWIL": out["MARWIL"] > out["MARWIL_gate"]}
    return out


def main() -> None:
    which, seeds = sys.argv[1], [int(s) for s in sys.argv[2:]]
    for seed in seeds:
        if which == "jax":
            out = gates(jrl, jax_datasets(seed), seed, None)
        else:
            import torch

            from ray_tpu_torch import rllib as trl
            torch.set_num_threads(2)
            data = (fixture_datasets(trl) if which == "port"
                    else port_datasets(seed))
            out = gates(trl, data, seed, "cpu")
        print(json.dumps({"package": which, "seed": seed, **out}),
              flush=True)


if __name__ == "__main__":
    main()
