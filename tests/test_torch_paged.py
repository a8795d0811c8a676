"""ray_tpu_torch.models.{paged,generate} against their ray_tpu counterparts.

Same weights in both packages (``params_from_jax``), fp32, JAX under
``default_matmul_precision("highest")``. Logits and written KV blocks are
compared at 1e-4 (fp32 summation order through 4 layers); greedy tokens
are compared exactly, except where the reference's top-2 logit gap is
inside that tolerance (a near-tie may flip argmax — none occurs at these
seeds, and the test says so if one ever does).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import generate as jgen
from ray_tpu.models import paged as jpg
from ray_tpu.models import transformer as jtf
from ray_tpu_torch.models import generate as tgen
from ray_tpu_torch.models import paged as tpg
from ray_tpu_torch.models import transformer as ttf
from ray_tpu_torch.models.convert import params_from_jax

TOL = 1e-4


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


@pytest.fixture(scope="module")
def models():
    jcfg = jtf.TransformerConfig.tiny(dtype=jnp.float32, remat=False)
    tcfg = ttf.TransformerConfig.tiny(dtype=torch.float32, remat=False)
    jp = jtf.init_params(jax.random.PRNGKey(7), jcfg)
    tp = params_from_jax(jax.device_get(jp), device="cpu")
    return jcfg, jp, tcfg, tp


PCFG_KW = dict(block_size=8, num_blocks=12, max_batch=2, max_blocks_per_seq=4)


def _i64(a):
    return torch.tensor(np.asarray(a), dtype=torch.int64)


def _caches(jcfg, tcfg):
    jc = jpg.init_paged_cache(jcfg, jpg.PagedConfig(**PCFG_KW))
    tc = tpg.init_paged_cache(tcfg, tpg.PagedConfig(**PCFG_KW), device="cpu")
    return jc, tc


def _assert_cache_equal(tc, jc):
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]), rtol=0, atol=TOL)


def _prefill_both(models, toks, row, jc, tc):
    jcfg, jp, tcfg, tp = models
    jl, jc = jpg.paged_prefill(jp, jcfg, jnp.asarray(toks), jc, jnp.asarray(row), 8)
    tl, tc = tpg.paged_prefill(tp, tcfg, _i64(toks), tc, _i64(row), 8)
    return np.asarray(jl), jc, tl, tc


def test_paged_prefill_logits_and_blocks_match_jax(models):
    jcfg, _, tcfg, _ = models
    jc, tc = _caches(jcfg, tcfg)
    toks = np.random.default_rng(0).integers(0, 256, (1, 16)).astype(np.int32)
    jl, jc, tl, tc = _prefill_both(models, toks, np.array([3, 5], np.int32), jc, tc)
    assert tl.shape == (16, tcfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=0, atol=TOL)
    _assert_cache_equal(tc, jc)
    # Only the slot's two blocks were written.
    written = tc["k"].abs().sum(dim=(0, 2, 3, 4)) > 0
    assert written.nonzero().flatten().tolist() == [3, 5]


def test_paged_decode_steps_match_jax(models):
    """Two slots prefilled into their blocks, then three batched decode
    steps: logits and the whole pool agree after every step."""
    jcfg, jp, tcfg, tp = models
    jc, tc = _caches(jcfg, tcfg)
    rng = np.random.default_rng(1)
    pa = rng.integers(0, 256, (1, 8)).astype(np.int32)
    pb = rng.integers(0, 256, (1, 8)).astype(np.int32)
    _, jc, _, tc = _prefill_both(models, pa, np.array([1], np.int32), jc, tc)
    _, jc, _, tc = _prefill_both(models, pb, np.array([2], np.int32), jc, tc)
    tables = np.array([[1, 4, 0, 0], [2, 6, 0, 0]], np.int32)
    lens = np.array([7, 5], np.int32)  # slot b's real prompt is 6 tokens
    tokens = np.array([pa[0, 7], 42], np.int32)
    for _ in range(3):
        jl, jc = jpg.paged_decode_step(jp, jcfg, jnp.asarray(tokens), jc, jnp.asarray(tables),
                                       jnp.asarray(lens))
        tl, tc = tpg.paged_decode_step(tp, tcfg, _i64(tokens), tc, _i64(tables), _i64(lens))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=TOL)
        _assert_cache_equal(tc, jc)
        tokens = np.asarray(jl).argmax(-1).astype(np.int32)
        lens = lens + 1


def test_paged_prefill_chunk_matches_jax(models):
    """A prefix prefilled into blocks [2, 3], then a chunk at positions
    16..23 attending to it through the slot's table."""
    jcfg, jp, tcfg, tp = models
    jc, tc = _caches(jcfg, tcfg)
    rng = np.random.default_rng(2)
    prefix = rng.integers(0, 256, (1, 16)).astype(np.int32)
    chunk = rng.integers(0, 256, (1, 8)).astype(np.int32)
    _, jc, _, tc = _prefill_both(models, prefix, np.array([2, 3], np.int32), jc, tc)
    table = np.array([2, 3, 7, 0], np.int32)
    crow = np.array([7], np.int32)
    jl, jc = jpg.paged_prefill_chunk(jp, jcfg, jnp.asarray(chunk), jc, jnp.asarray(table),
                                     jnp.asarray(crow), 8, jnp.int32(16))
    tl, tc = tpg.paged_prefill_chunk(tp, tcfg, _i64(chunk), tc, _i64(table), _i64(crow), 8, 16)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=TOL)
    _assert_cache_equal(tc, jc)
    # And the chunk's logits equal a full forward over prefix + chunk.
    full = ttf.forward(tp, _i64(np.concatenate([prefix, chunk], 1)), tcfg)[0, 16:]
    torch.testing.assert_close(tl, full, rtol=0, atol=TOL)


def test_prefill_and_sample_greedy_matches_jax(models):
    jcfg, jp, tcfg, tp = models
    jc, tc = _caches(jcfg, tcfg)
    toks = np.zeros((1, 16), np.int32)
    toks[0, :11] = np.random.default_rng(3).integers(0, 256, 11)
    row = np.array([4, 5], np.int32)
    jtok, _ = jpg.prefill_and_sample(jp, jcfg, jnp.asarray(toks), jc, jnp.asarray(row), 8,
                                     jnp.int32(11), jnp.float32(0.0), jax.random.PRNGKey(0))
    ttok, _ = tpg.prefill_and_sample(tp, tcfg, _i64(toks), tc, _i64(row), 8, 11,
                                     torch.tensor(0.0), torch.Generator().manual_seed(0))
    assert int(ttok) == int(jtok)


def test_contiguous_prefill_and_decode_match_jax(models):
    """generate.py's prefill + teacher-forced decode_step logits."""
    jcfg, jp, tcfg, tp = models
    toks = np.random.default_rng(4).integers(0, 256, (2, 10)).astype(np.int32)
    jl, jcache = jgen.prefill(jp, jcfg, jnp.asarray(toks[:, :4]), max_len=10)
    tl, tcache = tgen.prefill(tp, tcfg, _i64(toks[:, :4]), max_len=10)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=TOL)
    for pos in range(4, 10):
        jl, jcache = jgen.decode_step(jp, jcfg, jnp.asarray(toks[:, pos]), jcache, pos)
        tl, tcache = tgen.decode_step(tp, tcfg, _i64(toks[:, pos]), tcache, pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache[name].numpy(), np.asarray(jcache[name]), rtol=0, atol=TOL)


def test_generate_greedy_tokens_match_jax(models):
    jcfg, jp, tcfg, tp = models
    prompt = np.random.default_rng(5).integers(0, 256, (2, 5)).astype(np.int32)
    ref = np.asarray(jgen.generate(jp, jcfg, jnp.asarray(prompt), 8))
    out = tgen.generate(tp, tcfg, _i64(prompt), 8).numpy()
    assert out.shape == (2, 8)
    if not np.array_equal(out, ref):
        # A flip is only acceptable at a reference near-tie.
        cur = prompt
        for step in range(8):
            logits = np.asarray(jtf.forward(jp, jnp.asarray(cur), jcfg))[:, -1]
            for b in range(2):
                if out[b, step] != ref[b, step]:
                    top2 = np.sort(logits[b])[-2:]
                    assert top2[1] - top2[0] < TOL, (step, b, top2)
            cur = np.concatenate([cur, ref[:, step:step + 1]], axis=1)
    assert tgen.generate(tp, tcfg, _i64(prompt), 0).shape == (2, 0)


def test_filter_logits_matches_jax():
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((3, 50)).astype(np.float32) * 3
    for top_k, top_p in ((0, 1.0), (5, 1.0), (0, 0.7), (8, 0.5), (50, 0.999), (100, 1.0)):
        ref = np.asarray(jgen._filter_logits(jnp.asarray(logits), top_k, top_p))
        out = tgen._filter_logits(torch.tensor(logits), top_k, top_p).numpy()
        np.testing.assert_array_equal(np.isinf(out), np.isinf(ref), err_msg=f"{top_k} {top_p}")
        np.testing.assert_allclose(out[~np.isinf(out)], ref[~np.isinf(ref)], rtol=0, atol=1e-6)


def test_sample_tokens_greedy_rows_and_temperature_distribution():
    """Greedy rows are exact; sampled rows follow softmax(logits / t) (the
    RNGs differ from jax.random's, so the check is statistical)."""
    logits = torch.tensor([[0.0, 1.0, 2.0, -1.0], [3.0, 0.0, 0.0, 0.0]]).repeat(2000, 1)
    temps = torch.tensor([0.0, 0.7]).repeat(2000)
    g = torch.Generator().manual_seed(0)
    out = tpg.sample_tokens(logits, temps, g)
    assert torch.all(out[0::2] == 2)
    freq = torch.bincount(out[1::2], minlength=4).float() / 2000
    expect = torch.softmax(torch.tensor([3.0, 0.0, 0.0, 0.0]) / 0.7, -1)
    torch.testing.assert_close(freq, expect, rtol=0, atol=0.03)


def test_decode_loop_equals_stepwise_decode(models):
    """paged_decode_loop (one window) == n paged_decode_steps + sampling,
    including the in-place pool."""
    jcfg, _, tcfg, tp = models
    _, tc1 = _caches(jcfg, tcfg)
    _, tc2 = _caches(jcfg, tcfg)
    tables = _i64([[1, 2, 0, 0], [3, 0, 0, 0]])
    lens, toks, temps = _i64([5, 2]), _i64([9, 17]), torch.zeros(2)
    seq, tc1 = tpg.paged_decode_loop(tp, tcfg, toks, tc1, tables, lens, temps,
                                     torch.Generator().manual_seed(0), 4)
    step = []
    for _ in range(4):
        logits, tc2 = tpg.paged_decode_step(tp, tcfg, toks, tc2, tables, lens)
        toks = logits.argmax(-1)
        lens = lens + 1
        step.append(toks)
    assert torch.equal(seq, torch.stack(step))
    assert torch.equal(tc1["k"], tc2["k"]) and torch.equal(tc1["v"], tc2["v"])


def test_sampled_generate_runs_with_filters(models):
    _, _, tcfg, tp = models
    prompt = _i64([[1, 2, 3, 4]])
    g = torch.Generator().manual_seed(9)
    out = tgen.generate(tp, tcfg, prompt, 6, temperature=0.8, top_k=20, top_p=0.9, generator=g)
    assert out.shape == (1, 6) and int(out.min()) >= 0 and int(out.max()) < tcfg.vocab_size
    with pytest.raises(ValueError, match="Generator"):
        tgen.generate(tp, tcfg, prompt, 2, temperature=0.8)


def test_moe_paged_prefill_decode_and_contiguous_decode_match_jax():
    """The MoE MLP (top-2 of 4 experts) on the serving paths: paged prefill
    and decode, and the contiguous cache's decode, against the reference."""
    jcfg = jtf.TransformerConfig.tiny(dtype=jnp.float32, remat=False, num_experts=4)
    tcfg = ttf.TransformerConfig.tiny(dtype=torch.float32, remat=False, num_experts=4)
    jp = jtf.init_params(jax.random.PRNGKey(8), jcfg)
    tp = params_from_jax(jax.device_get(jp), device="cpu")
    jc, tc = _caches(jcfg, tcfg)
    toks = np.random.default_rng(6).integers(0, 256, (1, 8)).astype(np.int32)
    jl, jc, tl, tc = _prefill_both((jcfg, jp, tcfg, tp), toks, np.array([1], np.int32), jc, tc)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=0, atol=TOL)
    tables, lens = np.array([[1, 2, 0, 0]], np.int32), np.array([8], np.int32)
    tokens = np.asarray(jl)[-1:].argmax(-1).astype(np.int32)
    jl, jc = jpg.paged_decode_step(jp, jcfg, jnp.asarray(tokens), jc, jnp.asarray(tables),
                                   jnp.asarray(lens))
    tl, tc = tpg.paged_decode_step(tp, tcfg, _i64(tokens), tc, _i64(tables), _i64(lens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=TOL)
    _assert_cache_equal(tc, jc)
    jl, jcache = jgen.prefill(jp, jcfg, jnp.asarray(toks[:, :5]), max_len=8)
    tl, tcache = tgen.prefill(tp, tcfg, _i64(toks[:, :5]), max_len=8)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=TOL)
    jl, _ = jgen.decode_step(jp, jcfg, jnp.asarray(toks[:, 5]), jcache, 5)
    tl, _ = tgen.decode_step(tp, tcfg, _i64(toks[:, 5]), tcache, 5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=TOL)
