"""ray_tpu_torch.models.transformer against ray_tpu.models.transformer.

Both packages compute with the SAME weights: the JAX tree is converted
with ``params_from_jax`` (the two RNGs differ, so separately initialised
models are never compared). fp32 throughout, JAX under
``default_matmul_precision("highest")``; tolerances are fp32
summation-order noise: 1e-5 for single blocks, 1e-4 for 4-layer logits.
"""
import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

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


# ---------------------------------------------------------------------------
# Training half: loss, gradients, remat, MoE, counts
# ---------------------------------------------------------------------------

# Loss and gradients, fp32 on both sides: the gradients sum over 2 x 24
# tokens through 4 layers, so summation-order noise is ~1e-6 on O(1e-2)
# values; 1e-5 absolute (loss 1e-5).
GRAD_TOL = 1e-5


def _jax_tree_to_np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for name, value in tree.items():
        if isinstance(value, dict):
            out.update(_flat(value, f"{prefix}{name}."))
        else:
            out[prefix + name] = value
    return out


@pytest.mark.parametrize(
    "case",
    ["plain", "remat", "chunked", "remat_chunked_masked", "masked", "moe", "moe_remat_chunked",
     "dots", "attn", "moe_dots", "moe_attn_chunked", "wide_head", "off_grid_head"],
)
def test_loss_and_grads_match_jax(case):
    """``loss_fn`` and every parameter's gradient against
    ``jax.value_and_grad(ray_tpu.models.transformer.loss_fn)`` on the same
    converted weights, at the tiny config (GQA 4 q / 2 kv heads); the
    "dots" and "attn" cases run both sides under that remat policy;
    "wide_head" at d_model 512 with 2 q heads and 1 kv head of 256 (the head
    dims the wide kernels take on the card); "off_grid_head" at d_model 144
    with 2 q and 2 kv heads of 72 in 2 layers (off the 16 grid, as the
    750M flagship's 32 heads of 72, which the Hopper kernels take)."""
    policy = next((p for p in ("dots", "attn") if p in case), "full")
    kw = dict(remat="remat" in case or policy != "full", remat_policy=policy,
              logits_chunk=16 if "chunked" in case else 0,
              num_experts=4 if "moe" in case else 0)
    if case == "wide_head":
        kw.update(d_model=512, n_heads=2, n_kv_heads=1)
    if case == "off_grid_head":
        kw.update(d_model=144, n_heads=2, n_kv_heads=2, n_layers=2)
    jcfg = jtf.TransformerConfig.tiny(dtype=jnp.float32, **kw)
    tcfg = ttf.TransformerConfig.tiny(dtype=torch.float32, **kw)
    jp = jtf.init_params(jax.random.PRNGKey(3), jcfg)
    tp = params_from_jax(jax.device_get(jp), device="cpu")
    toks = _tokens((2, 25), seed=7)  # 24 inputs: chunk 16 pads the last chunk
    jbatch, tbatch = {"tokens": jnp.asarray(toks)}, {"tokens": torch.tensor(toks, dtype=torch.int64)}
    if "masked" in case:
        mask = (np.random.default_rng(8).random((2, 25)) > 0.3).astype(np.float32)
        jbatch["mask"], tbatch["mask"] = jnp.asarray(mask), torch.tensor(mask)
    with jax.default_matmul_precision("highest"):
        jloss, jgrads = jax.value_and_grad(jtf.loss_fn)(jp, jbatch, jcfg)
    jgrads = _flat(_jax_tree_to_np(jgrads))
    leaves = _flat(tp)
    for t in leaves.values():
        t.requires_grad_(True)
    loss = ttf.loss_fn(tp, tbatch, tcfg)
    grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
    assert abs(loss.item() - float(jloss)) <= GRAD_TOL
    assert set(grads) == set(jgrads)
    for name, g in grads.items():
        np.testing.assert_allclose(g.numpy(), jgrads[name], rtol=0, atol=GRAD_TOL, err_msg=name)


def test_forward_is_differentiable():
    """``forward`` carries no ``no_grad``: ``loss_fn`` through it gives a
    gradient on every parameter, and remat gives the same gradients."""
    cfg = ttf.TransformerConfig.tiny(dtype=torch.float32, remat=False)
    params = ttf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    leaves = _flat(params)
    for t in leaves.values():
        t.requires_grad_(True)
    batch = {"tokens": torch.tensor(_tokens((2, 17), seed=9), dtype=torch.int64)}
    logits = ttf.forward(params, batch["tokens"][:, :-1], cfg)
    assert logits.requires_grad
    grads = torch.autograd.grad(ttf.loss_fn(params, batch, cfg), list(leaves.values()))
    assert all(g is not None and torch.isfinite(g).all() and g.abs().sum() > 0 for g in grads)
    remat = dataclasses.replace(cfg, remat=True)
    grads_r = torch.autograd.grad(ttf.loss_fn(params, batch, remat), list(leaves.values()))
    for g, gr in zip(grads, grads_r):
        torch.testing.assert_close(g, gr, rtol=0, atol=1e-6)


@pytest.mark.parametrize("policy", ["dots", "attn"])
def test_selective_remat_policies_raise(policy):
    """A selective policy runs and gives "full"'s logits; a name the
    reference rejects is still rejected the same way (a ValueError)."""
    cfg = ttf.TransformerConfig.tiny(dtype=torch.float32, remat=True, remat_policy=policy)
    params = ttf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.zeros(1, 8, dtype=torch.int64)
    full = ttf.forward(params, toks, dataclasses.replace(cfg, remat_policy="full"))
    torch.testing.assert_close(ttf.forward(params, toks, cfg), full, rtol=0, atol=0)
    with pytest.raises(ValueError, match="remat_policy"):
        ttf.forward(params, toks, dataclasses.replace(cfg, remat_policy="bogus"))


class _OpCounts(TorchDispatchMode):
    """Counts every op the dispatcher runs (a cached output that a
    selective checkpoint hands back is not a run)."""

    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] += 1
        return func(*args, **(kwargs or {}))


def _fwd_bwd_counts(cfg, seed=0):
    """Op counts of ``loss_fn`` (forward) and of its gradient (backward,
    the checkpoint recompute included) at ``cfg``."""
    params = ttf.init_params(cfg, torch.Generator().manual_seed(seed), device="cpu")
    leaves = list(_flat(params).values())
    for t in leaves:
        t.requires_grad_(True)
    batch = {"tokens": torch.tensor(_tokens((2, 17), seed=12), dtype=torch.int64)}
    with _OpCounts() as fwd:
        loss = ttf.loss_fn(params, batch, cfg)
    with _OpCounts() as bwd:
        torch.autograd.grad(loss, leaves)
    return fwd.counts, bwd.counts


FLASH_FWD = torch.ops.ray_tpu_torch.flash_fwd.default
MM, BMM = torch.ops.aten.mm.default, torch.ops.aten.bmm.default


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
@pytest.mark.parametrize("policy", ["full", "dots", "attn"])
def test_selective_remat_recompute_counts(policy, moe):
    """What each policy recomputes, counted at the dispatcher over forward
    and backward at the tiny config (L = 4 layers):
      - the flash op runs 2·L times under "full" and "dots" (forward and
        recompute) and L times under "attn" (its saved (o, lse) are reused);
      - the backward re-runs, beyond what it runs without remat, every
        projection ``aten.mm`` but w_down's under "full" (6·L dense, 5·L
        MoE with the router: the non-reentrant checkpoint stops its
        recompute once every saved tensor is back, and nothing saves the
        layer's last product) and none under "dots"; under "dots" the MoE
        layer re-runs only its one product with a batch dim (over e)."""
    kw = dict(dtype=torch.float32, num_experts=4 if moe else 0)
    L = ttf.TransformerConfig.tiny().n_layers
    base_fwd, base_bwd = _fwd_bwd_counts(ttf.TransformerConfig.tiny(remat=False, **kw))
    fwd, bwd = _fwd_bwd_counts(ttf.TransformerConfig.tiny(remat=True, remat_policy=policy, **kw))
    assert fwd[FLASH_FWD] == base_fwd[FLASH_FWD] == L and base_bwd[FLASH_FWD] == 0
    assert fwd[FLASH_FWD] + bwd[FLASH_FWD] == (L if policy == "attn" else 2 * L)
    assert fwd[MM] == base_fwd[MM] and fwd[BMM] == base_fwd[BMM]
    mm_again, bmm_again = bwd[MM] - base_bwd[MM], bwd[BMM] - base_bwd[BMM]
    if policy == "dots":
        assert (mm_again, bmm_again) == (0, L if moe else 0)
    else:
        assert mm_again == (5 if moe else 6) * L
        assert bmm_again == (3 * L if moe else 0)


def test_token_nll_matches_jax():
    rng = np.random.default_rng(10)
    logits = rng.standard_normal((2, 6, 11)).astype(np.float32) * 3
    targets = rng.integers(0, 11, (2, 6)).astype(np.int32)
    mask = (rng.random((2, 6)) > 0.5).astype(np.float32)
    for m in (None, mask, np.zeros_like(mask)):
        ref = float(jtf.token_nll(jnp.asarray(logits), jnp.asarray(targets),
                                  None if m is None else jnp.asarray(m)))
        out = ttf.token_nll(torch.tensor(logits), torch.tensor(targets, dtype=torch.int64),
                            None if m is None else torch.tensor(m))
        assert abs(out.item() - ref) <= 1e-6


def test_moe_layer_blocks_and_shapes_match_jax():
    """MoE init shapes equal the reference's; its mlp_block (top-2 of 4
    experts, dense dispatch) matches on the same weights."""
    jcfg = jtf.TransformerConfig.tiny(dtype=jnp.float32, num_experts=4, remat=False)
    tcfg = ttf.TransformerConfig.tiny(dtype=torch.float32, num_experts=4, remat=False)
    ref_shapes = jtf.init_shapes(jcfg)
    tp_init = ttf.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    for name, shape in ref_shapes["layers"].items():
        assert tuple(tp_init["layers"][name].shape) == tuple(shape), name
    jp = jtf.init_params(jax.random.PRNGKey(1), jcfg)
    tp = params_from_jax(jax.device_get(jp), device="cpu")
    x = np.random.default_rng(11).standard_normal((2, 9, jcfg.d_model)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(jtf.mlp_block(jnp.asarray(x), jax.tree.map(lambda a: a[2], jp["layers"]),
                                       jcfg))
    out = ttf.mlp_block(torch.tensor(x), ttf.layer_params(tp, 2), tcfg)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)


FLAGSHIP = dict(vocab_size=32000, d_model=2304, n_layers=10, n_heads=18, n_kv_heads=18,
                d_ff=5760, max_seq_len=2048, remat=True)


@pytest.mark.parametrize(
    "name,kw",
    [("tiny", dict(vocab_size=256, d_model=64, n_layers=4, n_heads=4, n_kv_heads=2, d_ff=128)),
     ("tiny_moe", dict(vocab_size=256, d_model=64, n_layers=4, n_heads=4, n_kv_heads=2,
                       d_ff=128, num_experts=4)),
     ("llama7b", dict(vocab_size=32000, d_model=4096, n_layers=32, n_heads=32, n_kv_heads=32,
                      d_ff=11008)),
     ("flagship_750m", FLAGSHIP)],
)
def test_num_params_and_flops_match_jax(name, kw):
    jcfg, tcfg = jtf.TransformerConfig(**kw), ttf.TransformerConfig(**kw)
    assert ttf.num_params(tcfg) == jtf.num_params(jcfg)
    for seq in (128, 2048):
        assert ttf.flops_per_token(tcfg, seq) == jtf.flops_per_token(jcfg, seq)
    if name == "flagship_750m":
        assert ttf.num_params(tcfg) == 757_972_224
