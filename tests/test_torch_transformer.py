"""ray_tpu_torch.models.transformer against ray_tpu.models.transformer.

Both packages compute with the SAME weights: the JAX tree is converted
with ``params_from_jax`` (the two RNGs differ, so separately initialised
models are never compared). fp32 throughout, JAX under
``default_matmul_precision("highest")``; tolerances are fp32
summation-order noise: 1e-5 for single blocks, 1e-4 for 4-layer logits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import transformer as jtf
from ray_tpu_torch.models import transformer as ttf
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.ops.attention import flash_attention_plain


@pytest.fixture(scope="module")
def models():
    jcfg = jtf.TransformerConfig.tiny(dtype=jnp.float32, remat=False)
    tcfg = ttf.TransformerConfig.tiny(dtype=torch.float32, remat=False)
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.device_get(jp), device="cpu")
    return jcfg, jp, tcfg, tp


def _tokens(shape, seed=1, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def test_forward_logits_match_jax(models):
    jcfg, jp, tcfg, tp = models
    toks = _tokens((2, 24))
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jtf.forward(jp, jnp.asarray(toks), jcfg))
    out = ttf.forward(tp, torch.tensor(toks, dtype=torch.int64), tcfg)
    assert out.dtype == torch.float32 and out.shape == (2, 24, tcfg.vocab_size)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-4)


def test_forward_with_explicit_positions_matches_jax(models):
    jcfg, jp, tcfg, tp = models
    toks = _tokens((1, 16), seed=5)
    pos = (np.arange(16, dtype=np.int32) + 7)[None, :]
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jtf.forward(jp, jnp.asarray(toks), jcfg, positions=jnp.asarray(pos)))
    out = ttf.forward(tp, torch.tensor(toks, dtype=torch.int64), tcfg,
                      positions=torch.tensor(pos, dtype=torch.int64))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-4)


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((3, 5, 64)) * 3).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    ref = np.asarray(jtf.rms_norm(jnp.asarray(x), jnp.asarray(scale)))
    out = ttf.rms_norm(torch.tensor(x), torch.tensor(scale)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    # bf16 activations keep their dtype, with an fp32 variance.
    xb = torch.tensor(x).bfloat16()
    assert ttf.rms_norm(xb, torch.tensor(scale)).dtype == torch.bfloat16


def test_rope_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 500, (2, 7)).astype(np.int32)
    ref = np.asarray(jtf._rope(jnp.asarray(x), jnp.asarray(pos), 10000.0))
    out = ttf._rope(torch.tensor(x), torch.tensor(pos, dtype=torch.int64), 10000.0).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    # Position 0 is the identity; the rotation preserves each pair's norm.
    zero = ttf._rope(torch.tensor(x), torch.zeros(2, 7, dtype=torch.int64), 10000.0)
    torch.testing.assert_close(zero, torch.tensor(x))
    half = 8
    n_in = x[..., :half] ** 2 + x[..., half:] ** 2
    n_out = out[..., :half] ** 2 + out[..., half:] ** 2
    np.testing.assert_allclose(n_out, n_in, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("block", ["project_qkv", "attention_block", "mlp_block"])
def test_layer_blocks_match_jax(models, block):
    jcfg, jp, tcfg, tp = models
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 16, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32)[None], (2, 16))
    jlp = jax.tree.map(lambda a: a[1], jp["layers"])
    tlp = ttf.layer_params(tp, 1)
    tx, tpos = torch.tensor(x), torch.tensor(pos, dtype=torch.int64)
    with jax.default_matmul_precision("highest"):
        if block == "project_qkv":
            ref = jtf.project_qkv(jnp.asarray(x), jlp, jcfg, jnp.asarray(pos))
            out = ttf.project_qkv(tx, tlp, tcfg, tpos)
        elif block == "attention_block":
            ref = jtf.attention_block(jnp.asarray(x), jlp, jcfg, jnp.asarray(pos), return_kv=True)
            out = ttf.attention_block(tx, tlp, tcfg, tpos, return_kv=True)
        else:
            ref = (jtf.mlp_block(jnp.asarray(x), jlp, jcfg),)
            out = (ttf.mlp_block(tx, tlp, tcfg),)
        ref = [np.asarray(r) for r in ref]
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        assert tuple(o.shape) == r.shape
        np.testing.assert_allclose(o.numpy(), r, rtol=0, atol=1e-5)


def test_attn_fn_override_gqa_and_repeat(models):
    """A custom attention that declares ``supports_gqa`` gets kv-width K/V;
    one that does not gets K/V repeated to the q heads. Both give the
    default path's logits."""
    _, _, tcfg, tp = models
    toks = torch.tensor(_tokens((1, 12), seed=6), dtype=torch.int64)
    seen = []

    def native(q, k, v):
        seen.append(("native", k.shape[1]))
        return flash_attention_plain(q, k, v, True, q.shape[-1] ** -0.5)[0]

    native.supports_gqa = True

    def repeated(q, k, v):
        seen.append(("repeated", k.shape[1]))
        return flash_attention_plain(q, k, v, True, q.shape[-1] ** -0.5)[0]

    base = ttf.forward(tp, toks, tcfg)
    torch.testing.assert_close(ttf.forward(tp, toks, tcfg, attn_fn=native), base)
    torch.testing.assert_close(ttf.forward(tp, toks, tcfg, attn_fn=repeated), base)
    assert ("native", tcfg.n_kv_heads) in seen and ("repeated", tcfg.n_heads) in seen


def test_init_params_shapes_and_scales():
    """Same tree, shapes and init scales as the reference's init_params."""
    jcfg = jtf.TransformerConfig.tiny(d_model=128, d_ff=256)
    tcfg = ttf.TransformerConfig.tiny(d_model=128, d_ff=256)
    ref_shapes = jtf.init_shapes(jcfg)
    tp = ttf.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    got = {k: (v if not isinstance(v, dict) else {n: t for n, t in v.items()})
           for k, v in tp.items()}
    assert set(got) == set(ref_shapes)
    assert set(got["layers"]) == set(ref_shapes["layers"])
    for name, shape in ref_shapes["layers"].items():
        assert tuple(got["layers"][name].shape) == tuple(shape), name
    for name in ("embed", "final_norm", "lm_head"):
        assert tuple(got[name].shape) == tuple(ref_shapes[name]), name
    assert torch.equal(got["final_norm"], torch.ones(128))
    assert abs(got["embed"].std().item() - 1.0) < 0.05
    assert abs(got["layers"]["wq"].std().item() - 128**-0.5) < 0.05 * 128**-0.5
    assert abs(got["layers"]["w_down"].std().item() - 256**-0.5) < 0.05 * 256**-0.5
    bf = ttf.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu", dtype=torch.bfloat16)
    assert bf["layers"]["wq"].dtype == torch.bfloat16


def test_params_from_jax_keeps_names_layouts_and_casts(models):
    _, jp, _, tp = models
    host = jax.device_get(jp)
    assert set(tp) == set(host) and set(tp["layers"]) == set(host["layers"])
    np.testing.assert_array_equal(tp["layers"]["wq"].numpy(), np.asarray(host["layers"]["wq"]))
    bf = params_from_jax(host, device="cpu", dtype=torch.bfloat16)
    assert bf["lm_head"].dtype == torch.bfloat16
    # bf16 arrays from the JAX side convert too (via a lossless fp32 widening).
    jb = jax.device_get(jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp))
    tb = params_from_jax(jb, device="cpu")
    assert tb["embed"].dtype == torch.float32
    np.testing.assert_array_equal(tb["embed"].numpy(), np.asarray(jb["embed"], np.float32))
