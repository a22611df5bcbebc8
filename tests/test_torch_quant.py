"""The port's int8 weights (w8a16, ``ray_tpu_torch/models/quant.py`` and
the int8 branches of ``models/llama.py``) against ray_tpu on the CPU.

Inputs come from numpy seeds (or the JAX init) and cross as numpy arrays.
``quantize_tensor`` and ``quantize_params`` compare EXACTLY: int8 bytes
and f32 scales are equal bit for bit (both sides take the absmax in f32
and divide truly by 127 and by the scale; the port divides by a tensor
of 127s, since on a CUDA tensor a division by the Python scalar is a
reciprocal product).  ``fuse_for_decode`` runs under ``jax.jit`` in the
JAX package, where XLA turns ``amax / 127.0`` into a product with 1/127:
its scales land one ulp off the true quotient in a few columns, and an
int8 value whose quotient sits on a rounding boundary one step off.  The
port divides truly there too, so those compare to 1 ulp and 1 step.  Model
outputs on int8 weights compare at the f32 step tolerance of the other
port tests: the dequantised weights are equal, the matmuls sum in
another order."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jl
from ray_tpu.models import quant as jq
from ray_tpu_torch import bridge
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models import quant as tq

J_CFG = jl.LlamaConfig(vocab_size=211, dim=64, n_layers=2, n_heads=4,
                       n_kv_heads=2, mlp_dim=128, max_seq_len=256,
                       dtype=jnp.float32, param_dtype=jnp.float32,
                       remat=False)
T_CFG = tl.LlamaConfig(vocab_size=211, dim=64, n_layers=2, n_heads=4,
                       n_kv_heads=2, mlp_dim=128, max_seq_len=256,
                       dtype=torch.float32, param_dtype=torch.float32,
                       remat=False)
# f32 on both sides; matmul and reduction order differ (XLA vs ATen).
STEP_TOL = 1e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_tree_equal(got, want, path=""):
    """got: tensors, want: numpy; same keys, dtypes and bytes."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for key in want:
            _assert_tree_equal(got[key], want[key], f"{path}/{key}")
        return
    g = got.numpy()
    assert g.dtype == want.dtype and g.shape == want.shape, path
    np.testing.assert_array_equal(g, want, err_msg=path)


@pytest.fixture(scope="module")
def jparams():
    return jl.init_params(jax.random.PRNGKey(0), J_CFG)


@pytest.mark.parametrize("shape,stacked", [((64, 96), False),
                                           ((3, 64, 4, 16), True),
                                           ((2, 64, 128), True),
                                           ((512, 1000), False)])
def test_quantize_tensor_matches_jax(shape, stacked):
    w = (np.random.default_rng(len(shape)).standard_normal(shape)
         * 0.1).astype(np.float32)
    w[..., 3] = 0.0  # an all-zero column takes the 1e-8 floor
    want = _np(jq.quantize_tensor(jnp.asarray(w), stacked=stacked))
    got = tq.quantize_tensor(torch.from_numpy(w), stacked=stacked)
    _assert_tree_equal(got, want)
    deq = tq.dequantize_tensor(got, torch.float32)
    np.testing.assert_array_equal(
        deq.numpy(), np.asarray(jq.dequantize_tensor(
            jq.quantize_tensor(jnp.asarray(w), stacked=stacked),
            jnp.float32)))


def test_quantize_params_matches_jax(jparams):
    want = _np(jq.quantize_params(jparams))
    tp = bridge.params_from_jax(_np(jparams), device="cpu")
    got = tq.quantize_params(tp)
    _assert_tree_equal(got, want)
    # Norms and the embedding stay plain; every matrix is a q-dict.
    assert not isinstance(got["tok_embed"], dict)
    assert set(got["layers"]["attn"]["wq"]) == {"q", "scale"}
    assert tuple(got["layers"]["attn"]["wq"]["scale"].shape) == (2, 1, 1, 16)
    assert tq.quantized_bytes(got) == jq.quantized_bytes(
        jq.quantize_params(jparams))
    back = tq.dequantize_params(got, torch.float32)
    _assert_tree_equal(back, _np(jq.dequantize_params(
        jq.quantize_params(jparams), jnp.float32)))
    # cast_rest casts the unquantised leaves.
    cast = tq.quantize_params(tp, cast_rest=torch.bfloat16)
    assert cast["tok_embed"].dtype == torch.bfloat16
    assert cast["layers"]["ln_attn"].dtype == torch.bfloat16


def test_fuse_for_decode_matches_jax(jparams):
    jq_params = jq.quantize_params(jparams)
    want = _np(jq.fuse_for_decode(jq_params, J_CFG))
    tqp = bridge.params_from_jax(_np(jq_params), device="cpu")
    got = tq.fuse_for_decode(tqp, T_CFG)
    for part, key in (("attn", "wqkv"), ("mlp", "w_gateup")):
        g, w = got["layers"][part][key], want["layers"][part][key]
        gs, ws = g["scale"].numpy(), w["scale"]
        assert gs.shape == ws.shape and g["q"].shape == w["q"].shape
        ulps = np.abs(gs.view(np.int32).astype(np.int64) - ws.view(np.int32))
        assert ulps.max() <= 1, key
        dq = np.abs(g["q"].numpy().astype(np.int32) - w["q"])
        assert dq.max() <= 1 and (dq > 0).mean() < 1e-3, key
        # A q step only where the scale moved.
        cols = np.nonzero(dq.any(axis=1))
        assert (ulps[:, 0][cols] == 1).all(), key
    for part, key in (("attn", "wo"), ("mlp", "w_down")):
        _assert_tree_equal(got["layers"][part][key], want["layers"][part][key])
    _assert_tree_equal(got["lm_head"], want["lm_head"])
    # The port's fused leaves are exactly its own quantiser applied to the
    # dequantised concatenation, layer by layer.
    a = tqp["layers"]["attn"]
    for i in range(2):
        deq = [(a[n]["q"][i].float() * a[n]["scale"][i]).reshape(64, -1)
               for n in ("wq", "wk", "wv")]
        want_i = tq.quantize_tensor(torch.cat(deq, dim=1))
        assert torch.equal(got["layers"]["attn"]["wqkv"]["q"][i],
                           want_i["q"])
        assert torch.equal(got["layers"]["attn"]["wqkv"]["scale"][i],
                           want_i["scale"])
    assert set(got["layers"]["attn"]) == {"wqkv", "wo"}
    assert set(got["layers"]["mlp"]) == {"w_gateup", "w_down"}
    assert tuple(got["layers"]["attn"]["wqkv"]["q"].shape) == (2, 64, 128)
    with pytest.raises(ValueError, match="single-device"):
        tq.fuse_for_decode(got, dataclasses.replace(T_CFG,
                                                    tensor_parallel=True))


def test_int8_artifact_crosses_the_bridge_exactly(jparams):
    """{"q", "scale"} leaves cross params_from_jax by its recursion:
    int8 and f32 exactly, and back through params_to_numpy."""
    want = _np(jq.fuse_for_decode(jq.quantize_params(jparams), J_CFG))
    got = bridge.params_from_jax(want, device="cpu")
    _assert_tree_equal(got, want)
    assert got["layers"]["attn"]["wqkv"]["q"].dtype == torch.int8
    assert got["lm_head"]["scale"].dtype == torch.float32
    back = bridge.params_to_numpy(got)
    _assert_tree_equal(bridge.params_from_jax(back, device="cpu"), want)


def test_init_quantized_llama_tree_matches_jax():
    """Same tree, shapes, dtypes and scale layouts as the JAX init (the
    draws differ); the fused artifact of it too."""
    want = _np(jq.init_quantized_llama(jax.random.PRNGKey(1), J_CFG))
    got = tq.init_quantized_llama(torch.Generator().manual_seed(1), T_CFG,
                                  device="cpu")

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        return (tuple(tree.shape), str(tree.dtype).split(".")[-1])

    assert shapes(bridge.params_from_jax(want, device="cpu")) == shapes(got)
    for leaf in (got["layers"]["attn"]["wq"], got["layers"]["mlp"]["w_down"],
                 got["lm_head"]):
        assert (leaf["scale"] > 0).all()
        # Every output column reaches the int8 range's end.
        amax = leaf["q"].abs().amax(dim=tuple(range(leaf["q"].ndim - 1)))
        assert (amax == 127).all()
    fused = tq.fuse_for_decode(got, T_CFG)
    assert tuple(fused["layers"]["mlp"]["w_gateup"]["scale"].shape) == \
        (2, 1, 256)


@pytest.mark.parametrize("fuse,kv_int8", [(False, False), (True, False),
                                           (True, True)])
def test_paged_unfused_steps_on_int8_weights_match_jax(jparams, fuse,
                                                       kv_int8):
    """Paged prefill, then unfused decode steps, on int8 weights
    (separate leaves, or the fused wqkv / w_gateup artifact; int8 head):
    logits and pools against the JAX package, both dequantising one
    layer at a time (``_deq_layer``)."""
    jc = dataclasses.replace(J_CFG, kv_int8=kv_int8)
    tc = dataclasses.replace(T_CFG, kv_int8=kv_int8)
    jqp = jq.quantize_params(jparams)
    if fuse:
        jqp = jq.fuse_for_decode(jqp, J_CFG)
    tqp = bridge.params_from_jax(_np(jqp), device="cpu")
    page, num_pages = 16, 8
    rng = np.random.default_rng(4)
    toks = rng.integers(0, 211, (2, 32)).astype(np.int32)
    lens = np.asarray([20, 29], np.int32)
    rows = np.asarray([[0, 1, 2, 3], [4, 5, 6, 7]], np.int32)
    jcache = jl.init_paged_cache(jc, num_pages, page)
    tcache = tl.init_paged_cache(tc, num_pages, page, device="cpu")
    lg_j, jcache = jl.prefill_batch_paged(
        jqp, jnp.asarray(toks), jnp.asarray(lens), jnp.asarray(rows), jc,
        jcache)
    lg_t, tcache = tl.prefill_batch_paged(
        tqp, torch.from_numpy(toks), torch.from_numpy(lens),
        torch.from_numpy(rows), tc, tcache)
    np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j),
                               atol=STEP_TOL, rtol=STEP_TOL)
    cur = np.argmax(np.asarray(lg_j), -1).astype(np.int32)
    lengths = lens.copy()
    active = np.ones(2, bool)
    for _ in range(1 if kv_int8 else 2):
        lg_j, jcache, nl = jl.decode_slots_paged(
            jqp, jnp.asarray(cur), jnp.asarray(active), jnp.asarray(rows),
            jnp.asarray(lengths), jc, jcache)
        lg_t, tcache, _ = tl.decode_slots_paged(
            tqp, torch.from_numpy(cur), torch.from_numpy(active),
            torch.from_numpy(rows), torch.from_numpy(lengths), tc, tcache)
        np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j),
                                   atol=STEP_TOL, rtol=STEP_TOL)
        cur = np.argmax(np.asarray(lg_j), -1).astype(np.int32)
        lengths = np.asarray(nl)
    for key in jcache:
        want = np.asarray(jcache[key])[:, :, :-1] if key in "kv" \
            else np.asarray(jcache[key])[:, :-1]
        got = tcache[key].numpy()[:, :, :-1] if key in "kv" \
            else tcache[key].numpy()[:, :-1]
        if key in "kv" and kv_int8:
            # int8 bytes: a value on a rounding boundary may store one
            # step apart (the k/v differ in their last f32 bits).
            assert np.abs(got.astype(np.int32) - want).max() <= 1
        else:
            np.testing.assert_allclose(got, want, atol=STEP_TOL,
                                       rtol=STEP_TOL, err_msg=key)


def test_fused_qkv_rows_are_contiguous(jparams):
    """The wqkv branch's q, k and v are contiguous: K1/K4 take only
    contiguous rows on the card (v is a column slice of the product)."""
    tqp = bridge.params_from_jax(_np(jq.fuse_for_decode(
        jq.quantize_params(jparams), J_CFG)), device="cpu")
    layer = tl._deq_layer(tl._layers(tqp["layers"], 2)[0], torch.float32)
    x = torch.randn((1, 5, 64))
    sin, cos = tl.rope_table(T_CFG, torch.arange(5)[None])
    for t in tl._qkv(x, layer, T_CFG, sin, cos):
        assert t.is_contiguous()


def test_adapter_quant_is_the_paged_adapter():
    adapter = tq.llama_paged_adapter_quant(T_CFG)
    assert adapter.ragged_step is not None and adapter.copy_page is not None
