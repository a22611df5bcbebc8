"""Write the JAX tests' offline Pendulum datasets as ``.npz`` files.

The JAX package's offline tests log their data with a seed-0 SAC
(``tests/test_rllib_offline.py::pendulum_dataset``: 18 iterations, then
4,000 steps; ``tests/test_rllib_breadth2.py::pendulum_dataset``: 15
iterations, then 3,000 steps), its deterministic action plus σ 0.35
noise, ``OfflineDataset.collect(..., seed=3)``.  This script runs that
recipe with the JAX package on the CPU (one SAC run: its first 15
iterations are the 15-iteration fixture's) and writes both datasets, so
the port's offline learners can be held to the JAX tests' gates on the
JAX tests' own data (``chip_smoke.py``, phase 20).

    JAX_PLATFORMS=cpu python scripts/make_offline_fixtures.py
"""

import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from ray_tpu.rllib import OfflineDataset, SACConfig  # noqa: E402
from ray_tpu.rllib.env import Pendulum  # noqa: E402

FILES = {15: ("pendulum_sac15_3000.npz", 3000),
         18: ("pendulum_sac18_4000.npz", 4000)}


def main() -> None:
    sac = (SACConfig().environment("Pendulum-v1")
           .training(steps_per_iteration=256, train_batch_size=128,
                     learning_starts=500)
           .debugging(seed=0).build())

    def behavior(obs, rng):
        a = sac.compute_single_action(obs)  # deterministic head
        return np.clip(a + rng.normal(0, 0.35, a.shape), -2.0, 2.0
                       ).astype(np.float32)

    for it in range(1, 19):
        sac.train()
        if it in FILES:
            name, steps = FILES[it]
            ds = OfflineDataset.collect(Pendulum(), behavior,
                                        num_steps=steps, seed=3)
            ds.save(os.path.join(HERE, "data", name))
            print(f"{name}: {len(ds)} rows, {int(ds.done.sum())} episode "
                  f"ends, mean reward {ds.reward.mean():.4f}")


if __name__ == "__main__":
    main()
