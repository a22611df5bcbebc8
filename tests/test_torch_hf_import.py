"""Port of the HF Llama import against the JAX package's import and
against ``transformers`` on the CPU: config translation (with the
Llama-3.1 ``llama3`` rope scaling), params equal to the JAX import's
bit for bit, logits against the HF model within the JAX test's
tolerances, the port's own ``.safetensors`` reader against shards and
files written by the ``safetensors`` package, ``quantize=True`` against
the port's quantiser, dtypes kept through the import, and the refusals
(biases, a missing tensor, an unconsumed tensor, an unknown rope
type)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.models import hf_import as jhf
from ray_tpu_torch.models import hf_import as thf
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models import quant as tquant

transformers = pytest.importorskip("transformers")
safetensors = pytest.importorskip("safetensors")

F32 = {"dtype": torch.float32, "param_dtype": torch.float32}


def _hf_model(seed=0, **kw):
    cfg = transformers.LlamaConfig(**{
        "vocab_size": 211, "hidden_size": 64, "intermediate_size": 128,
        "num_hidden_layers": 2, "num_attention_heads": 4,
        "num_key_value_heads": 2, "max_position_embeddings": 128,
        "rope_theta": 500_000.0, "rms_norm_eps": 1e-5,
        "tie_word_embeddings": False, "attention_bias": False, **kw})
    torch.manual_seed(seed)
    return transformers.LlamaForCausalLM(cfg).eval()


@pytest.fixture(scope="module")
def tiny_hf():
    return _hf_model()


def _leaves(tree):
    if isinstance(tree, dict):
        return {f"{k}.{p}" if p else k: x
                for k in sorted(tree) for p, x in _leaves(tree[k]).items()}
    return {"": tree}


def test_config_translation_matches_jax(tiny_hf):
    cfg = thf.llama_config_from_hf(tiny_hf.config)
    jcfg = jhf.llama_config_from_hf(tiny_hf.config)
    for f in ("vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads",
              "mlp_dim", "max_seq_len", "rope_theta", "norm_eps",
              "tie_embeddings", "rope_scaling"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert (cfg.dim, cfg.n_layers, cfg.n_heads, cfg.n_kv_heads) == \
        (64, 2, 4, 2)
    scaled = {"vocab_size": 100, "hidden_size": 32,
              "num_hidden_layers": 1, "num_attention_heads": 2,
              "intermediate_size": 64,
              "rope_scaling": {"rope_type": "llama3", "factor": 8.0,
                               "low_freq_factor": 1.0,
                               "high_freq_factor": 4.0,
                               "original_max_position_embeddings": 64}}
    assert thf.llama_config_from_hf(scaled).rope_scaling == \
        jhf.llama_config_from_hf(scaled).rope_scaling == (8.0, 1.0, 4.0, 64)
    assert thf.llama_config_from_hf(scaled).n_kv_heads == 2


def test_params_equal_the_jax_import(tiny_hf):
    tp, cfg = thf.load_llama_from_hf(tiny_hf, config_overrides=F32,
                                     device="cpu")
    jp, _ = jhf.load_llama_from_hf(
        tiny_hf, config_overrides={"dtype": jnp.float32,
                                   "param_dtype": jnp.float32})
    want = _leaves(jax.tree.map(np.asarray, jp))
    got = _leaves(tp)
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == torch.float32 and tuple(got[k].shape) == \
            w.shape, k
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)


def test_forward_matches_transformers(tiny_hf):
    params, cfg = thf.load_llama_from_hf(tiny_hf, config_overrides=F32,
                                         device="cpu")
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 24))
    with torch.no_grad():
        ref = tiny_hf(torch.from_numpy(toks)).logits.numpy()
        ours = tllama.forward(params, torch.from_numpy(toks), cfg).numpy()
    np.testing.assert_array_equal(ref.argmax(-1), ours.argmax(-1))
    np.testing.assert_allclose(ours, ref, atol=2e-3, rtol=2e-3)


def test_llama31_rope_scaling_matches_transformers():
    model = _hf_model(
        seed=2, vocab_size=151, max_position_embeddings=256,
        rope_scaling={"rope_type": "llama3", "factor": 8.0,
                      "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                      "original_max_position_embeddings": 64})
    params, cfg = thf.load_llama_from_hf(model, config_overrides=F32,
                                         device="cpu")
    assert cfg.rope_scaling == (8.0, 1.0, 4.0, 64)
    # Long enough that scaled and unscaled frequencies diverge.
    toks = np.random.default_rng(4).integers(0, 151, (1, 96))
    with torch.no_grad():
        ref = model(torch.from_numpy(toks)).logits.numpy()
        ours = tllama.forward(params, torch.from_numpy(toks), cfg).numpy()
    np.testing.assert_array_equal(ref.argmax(-1), ours.argmax(-1))
    np.testing.assert_allclose(ours, ref, atol=3e-3, rtol=3e-3)


def test_reader_matches_safetensors_shards(tiny_hf, tmp_path):
    """Shards written by ``save_pretrained`` (two, by a small shard
    size) read back through the port's reader equal the live import, and
    a bf16/f16/int file equals ``safe_open``'s tensors bit for bit."""
    from safetensors import safe_open
    from safetensors.torch import save_file

    tiny_hf.save_pretrained(tmp_path, safe_serialization=True,
                            max_shard_size="100KB")
    shards = sorted(p.name for p in tmp_path.glob("*.safetensors"))
    assert len(shards) >= 2
    params, _ = thf.load_llama_from_hf(str(tmp_path), config_overrides=F32,
                                       device="cpu")
    live, _ = thf.load_llama_from_hf(tiny_hf, config_overrides=F32,
                                     device="cpu")
    for k, v in _leaves(live).items():
        assert torch.equal(_leaves(params)[k], v), k
    g = torch.Generator().manual_seed(1)
    mixed = {"a": torch.randn((3, 5), generator=g).to(torch.bfloat16),
             "b": torch.randn((7,), generator=g).to(torch.float16),
             "c": torch.randint(-100, 100, (2, 2, 3), generator=g,
                                dtype=torch.int8),
             "d": torch.randn((4, 4), generator=g, dtype=torch.float64),
             "e": torch.zeros((0, 3))}
    path = str(tmp_path / "mixed.bin")
    save_file(mixed, path, metadata={"format": "pt"})
    got = thf.read_safetensors(path)
    assert set(got) == set(mixed)
    with safe_open(path, framework="pt") as f:
        for name in f.keys():
            want = f.get_tensor(name)
            assert got[name].dtype == want.dtype, name
            assert got[name].shape == want.shape, name
            assert torch.equal(got[name], want), name
    with open(str(tmp_path / "short.bin"), "wb") as f:
        f.write(b"\x10\x00")
    with pytest.raises(ValueError, match="too short"):
        thf.read_safetensors(str(tmp_path / "short.bin"))


def test_import_keeps_each_tensors_dtype(tiny_hf):
    """A bf16 checkpoint imports into bf16 without a widened copy: every
    leaf equals the f32 import rounded to bf16, and a bf16 source into
    bf16 params is a pure copy of its bits."""
    sd = {k: v.to(torch.bfloat16) for k, v in tiny_hf.state_dict().items()}
    cfg = thf.llama_config_from_hf(tiny_hf.config, dtype=torch.bfloat16,
                                   param_dtype=torch.bfloat16)
    got = _leaves(thf.params_from_hf_state_dict(sd, cfg, device="cpu"))
    ref = _leaves(thf.params_from_hf_state_dict(
        sd, cfg, param_dtype=torch.float32, device="cpu"))
    for k, v in got.items():
        assert v.dtype == torch.bfloat16, k
        assert torch.equal(v, ref[k].to(torch.bfloat16)), k
    wq = sd["model.layers.1.self_attn.q_proj.weight"]
    assert torch.equal(got["layers.attn.wq"][1],
                       wq.T.reshape(64, 4, 16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantized_import_equals_the_ports_quantiser(tiny_hf, dtype):
    sd = {k: v.to(dtype) for k, v in tiny_hf.state_dict().items()}
    cfg = thf.llama_config_from_hf(tiny_hf.config, param_dtype=dtype)
    qp = thf.params_from_hf_state_dict(sd, cfg, quantize=True, device="cpu")
    want = tquant.quantize_params(
        thf.params_from_hf_state_dict(sd, cfg, device="cpu"))
    got, want = _leaves(qp), _leaves(want)
    assert set(got) == set(want)
    assert got["layers.attn.wq.q"].dtype == torch.int8
    assert tuple(got["layers.attn.wq.scale"].shape) == (2, 1, 1, 16)
    assert tuple(got["lm_head.scale"].shape) == (1, 211)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and torch.equal(got[k], w), k


def test_refusals(tiny_hf):
    cfg = thf.llama_config_from_hf(tiny_hf.config, **F32)
    sd = dict(tiny_hf.state_dict())
    sd["model.layers.0.self_attn.q_proj.bias"] = torch.zeros(64)
    with pytest.raises(ValueError, match="unconsumed"):
        thf.params_from_hf_state_dict(sd, cfg, device="cpu")
    sd = dict(tiny_hf.state_dict())
    del sd["model.layers.1.mlp.up_proj.weight"]
    with pytest.raises(KeyError, match="up_proj"):
        thf.params_from_hf_state_dict(sd, cfg, device="cpu")
    base = {"vocab_size": 100, "hidden_size": 32, "num_hidden_layers": 1,
            "num_attention_heads": 2, "num_key_value_heads": 2,
            "intermediate_size": 64}
    for bias in ("attention_bias", "mlp_bias"):
        with pytest.raises(NotImplementedError, match="bias"):
            thf.llama_config_from_hf({**base, bias: True})
    with pytest.raises(NotImplementedError, match="rope_scaling"):
        thf.llama_config_from_hf({**base, "rope_scaling": {
            "rope_type": "yarn", "factor": 2.0}})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            thf.params_from_hf_state_dict(dict(tiny_hf.state_dict()), cfg)
