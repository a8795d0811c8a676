"""ray_tpu_torch.parallel.train_step against ray_tpu.parallel.train_step.

The optimizer is held to the reference's optax chain (schedule, clipping,
AdamW) and a 5-step ``make_train_step`` trajectory to
``ray_tpu.parallel.make_train_step`` at ``MeshPlan(dp=1)``, from the same
converted weights and the same numpy-seeded tokens. fp32 on both sides,
JAX under ``default_matmul_precision("highest")``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import transformer as jtf
from ray_tpu.parallel import MeshPlan, build_mesh
from ray_tpu.parallel import make_train_state as jax_make_train_state
from ray_tpu.parallel import make_train_step as jax_make_train_step
from ray_tpu.parallel.train_step import make_optimizer as jax_make_optimizer
from ray_tpu_torch.models import transformer as ttf
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.parallel import make_optimizer, make_train_state, make_train_step
from ray_tpu_torch.parallel.train_step import param_leaves


@pytest.mark.parametrize("lr,warmup", [(3e-4, 10), (3e-4, 100), (1e-2, 1), (1e-3, 0)])
def test_learning_rate_matches_optax_schedule(lr, warmup):
    """Steps 0..1,100 (through warm-up, the cosine and past its end): the
    reference's schedule, evaluated in fp32, to fp32 rounding."""
    sched = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, max(warmup * 10, 1000))
    opt = make_optimizer(lr=lr, warmup=warmup)
    counts = np.arange(0, 1101)
    ref = np.asarray(jax.vmap(sched)(jnp.asarray(counts)))
    got = np.array([opt.learning_rate(int(c)) for c in counts])
    assert (got[0] == 0.0) == (warmup > 0)  # count 0 is the warm-up's start
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=lr * 1e-6)


@pytest.mark.parametrize("scale", [0.1, 10.0], ids=["below_clip", "above_clip"])
def test_one_update_matches_optax_chain(scale):
    """One ``Optimizer.update`` on fixed gradients equals the optax chain's
    (clip_by_global_norm, then adamw) at a step with a non-zero lr, with
    the norm returned before clipping."""
    rng = np.random.default_rng(0)
    p_np = {"a": rng.standard_normal((5, 3)).astype(np.float32),
            "b": {"c": rng.standard_normal(7).astype(np.float32)}}
    g_np = [{"a": rng.standard_normal((5, 3)).astype(np.float32) * scale,
             "b": {"c": rng.standard_normal(7).astype(np.float32) * scale}} for _ in range(3)]
    jopt = jax_make_optimizer(lr=1e-2, warmup=1)
    jp = jax.tree.map(jnp.asarray, p_np)
    jstate = jopt.init(jp)
    opt = make_optimizer(lr=1e-2, warmup=1)
    tp = {"a": torch.tensor(p_np["a"]), "b": {"c": torch.tensor(p_np["b"]["c"])}}
    state = opt.init(tp)
    for grads in g_np:  # update 0 has lr 0; updates 1 and 2 move
        jg = jax.tree.map(jnp.asarray, grads)
        updates, jstate = jopt.update(jg, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        tp["a"].grad = torch.tensor(grads["a"])
        tp["b"]["c"].grad = torch.tensor(grads["b"]["c"])
        with torch.no_grad():
            gnorm = opt.update(tp, state)
        assert abs(gnorm.item() - float(optax.global_norm(jg))) <= 1e-5 * gnorm.item()
    assert state.count == 3
    np.testing.assert_allclose(tp["a"].numpy(), np.asarray(jp["a"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tp["b"]["c"].numpy(), np.asarray(jp["b"]["c"]), rtol=0, atol=1e-6)


def test_train_step_trajectory_matches_jax():
    """5 steps of ``make_train_step`` from the reference's initial weights:
    per-step loss and grad norm, and every parameter at the end. Adam
    normalises each update, so the params differ by summation-order noise
    times lr per step: 1e-5 after 5 steps at lr <= 1e-3; loss and norm
    1e-5 relative."""
    jcfg = jtf.TransformerConfig.tiny(dtype=jnp.float32, remat=True)
    tcfg = ttf.TransformerConfig.tiny(dtype=torch.float32, remat=True)
    plan = MeshPlan(dp=1)
    mesh = build_mesh(plan, jax.devices()[:1])
    jopt = jax_make_optimizer(lr=1e-3, warmup=2)
    tokens = np.random.default_rng(5).integers(0, jcfg.vocab_size, (2, 25)).astype(np.int32)
    with jax.default_matmul_precision("highest"):
        jparams, jstate, _ = jax_make_train_state(jcfg, plan, mesh, jopt, seed=0)
        # The first step donates the params: copy them to the host first.
        params = params_from_jax(jax.device_get(jparams), device="cpu")
        jstep = jax_make_train_step(jcfg, plan, mesh, jopt)
        jbatch = {"tokens": jnp.asarray(tokens)}
        ref = []
        for _ in range(5):
            jparams, jstate, m = jstep(jparams, jstate, jbatch)
            ref.append((float(m["loss"]), float(m["grad_norm"])))
        jfinal = params_from_jax(jax.device_get(jparams), device="cpu")
    opt = make_optimizer(lr=1e-3, warmup=2)
    for p in param_leaves(params):
        p.requires_grad_(True)
    state = opt.init(params)
    step = make_train_step(tcfg, opt)
    batch = {"tokens": torch.tensor(tokens, dtype=torch.int64)}
    for i, (loss_ref, gnorm_ref) in enumerate(ref):
        params_out, state, m = step(params, state, batch)
        assert params_out is params  # updated in place
        assert abs(m["loss"].item() - loss_ref) <= 1e-5 * loss_ref, (i, m, ref[i])
        assert abs(m["grad_norm"].item() - gnorm_ref) <= 1e-5 * gnorm_ref, (i, m, ref[i])
    assert state.count == 5
    assert ref[-1][0] < ref[0][0]
    for got, want in zip(param_leaves(params), param_leaves(jfinal)):
        np.testing.assert_allclose(got.detach().numpy(), want.numpy(), rtol=0, atol=1e-5)


def test_make_train_state_gives_fp32_leaves_that_require_grad():
    cfg = ttf.TransformerConfig.tiny(dtype=torch.float32)
    params, state = make_train_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    leaves = param_leaves(params)
    assert len(leaves) == 3 + 9
    assert all(p.dtype == torch.float32 and p.requires_grad and p.is_leaf for p in leaves)
    assert sum(p.numel() for p in leaves) == ttf.num_params(cfg)
    assert state.count == 0 and len(state.adamw.param_groups[0]["params"]) == len(leaves)
    group = state.adamw.param_groups[0]
    assert group["betas"] == (0.9, 0.95) and group["eps"] == 1e-8
    assert group["weight_decay"] == 0.1


def test_first_update_has_lr_zero_and_grads_are_released():
    """As optax's schedule at count 0: the first step leaves the params
    unchanged (lr 0 scales the decay too), and no gradient stays held."""
    cfg = ttf.TransformerConfig.tiny(dtype=torch.float32, n_layers=2)
    params, state = make_train_state(cfg, torch.Generator().manual_seed(1), device="cpu",
                                     optimizer=make_optimizer(warmup=5))
    before = [p.detach().clone() for p in param_leaves(params)]
    step = make_train_step(cfg, make_optimizer(warmup=5))
    toks = torch.randint(0, cfg.vocab_size, (2, 9), generator=torch.Generator().manual_seed(2))
    _, state, m = step(params, state, {"tokens": toks})
    assert torch.isfinite(m["loss"]) and m["grad_norm"] > 0
    for p, b in zip(param_leaves(params), before):
        assert torch.equal(p.detach(), b) and p.grad is None
    step(params, state, {"tokens": toks})
    assert any(not torch.equal(p.detach(), b) for p, b in zip(param_leaves(params), before))
