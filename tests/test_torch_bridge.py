"""Parameter bridge JAX → numpy → ray_tpu_torch, and the port's import
boundary (it must never import jax or any module of ray_tpu)."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu_torch import bridge, resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dataclasses.replace(jllama.LLAMA_TINY, dtype=jnp.float32)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_round_trip_is_bit_exact(dtype):
    params = jllama.init_params(jax.random.PRNGKey(0), CFG)
    params = jax.tree.map(lambda a: np.asarray(a.astype(dtype)), params)
    t = bridge.params_from_jax(params, device="cpu")
    want_dtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    back = bridge.params_to_numpy(t, bf16_dtype=jnp.bfloat16)
    for (name, a), (_, tt), (_, b) in zip(_leaves(params), _leaves(t),
                                          _leaves(back)):
        assert tt.dtype == want_dtype, name
        assert tuple(tt.shape) == a.shape, name
        assert b.dtype == a.dtype, name
        # Compare bits, not values: -0.0 / NaN payloads must survive.
        bits = np.uint32 if dtype == jnp.float32 else np.uint16
        np.testing.assert_array_equal(a.view(bits), b.view(bits),
                                      err_msg=name)


def test_bf16_without_target_dtype_crosses_as_exact_f32():
    a = np.asarray(jnp.asarray([1.5, -2.25, 3e-3, 65504.0], jnp.bfloat16))
    t = bridge.params_from_jax({"w": a}, device="cpu")["w"]
    back = bridge.params_to_numpy({"w": t})["w"]
    assert back.dtype == np.float32
    np.testing.assert_array_equal(back, a.astype(np.float32))


def test_cuda_default_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    assert resolve_device("cpu") == torch.device("cpu")


def test_port_imports_neither_jax_nor_ray_tpu():
    code = (
        "import importlib, pkgutil, sys\n"
        "import ray_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    ray_tpu_torch.__path__, 'ray_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "import chip_pair\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'ray_tpu', 'optax', 'orbax')]\n"
        "assert not bad, bad\n"
        "need = {'ray_tpu_torch.models.quant', 'ray_tpu_torch.ops.fused_decode',\n"
        "        'ray_tpu_torch.models.mamba2', 'ray_tpu_torch.ops.mamba_ssd',\n"
        "        'ray_tpu_torch.ops.ragged_paged_attention',\n"
        "        'ray_tpu_torch.train.trainer', 'ray_tpu_torch.train.step',\n"
        "        'ray_tpu_torch.train.state', 'ray_tpu_torch.train.checkpoint'}\n"
        "assert need <= set(mods), sorted(need - set(mods))\n"
        "print(len(mods))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 10
