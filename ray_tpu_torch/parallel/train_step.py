"""Single-device train state and train step.

Counterpart of the single-device part of ``ray_tpu/parallel/train_step.py``
(meshes, shardings and the pipeline wait for ROADMAP A6), held to it by
``tests/test_torch_train_step.py``.

- ``make_optimizer`` reproduces the reference's optax chain exactly:
  ``clip_by_global_norm(grad_clip)`` (scale by ``max_norm / g_norm`` only
  when ``g_norm >= max_norm``, with no epsilon), then AdamW (b1 0.9, b2
  0.95, eps 1e-8, decay on every parameter) under
  ``warmup_cosine_decay_schedule(0, lr, warmup, max(10·warmup, 1000))``
  evaluated at the update count starting at 0, so the first update has
  lr 0. ``torch.optim.AdamW`` with its lr set by hand before each step
  computes the same update.
- ``make_train_state`` → ``(params, opt_state)``: fp32 leaf tensors that
  require grad, and the optimizer's state over them.
- ``make_train_step`` → ``step(params, opt_state, batch)``. Params and
  optimizer state are updated IN PLACE, which takes the place of the
  reference's donated arguments; the step returns them for the same
  calling convention.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ray_tpu_torch.models import transformer as tf

# optax.adamw's settings in the reference chain
# (ray_tpu/parallel/train_step.py:27-32).
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.95, 1e-8


def param_leaves(params: Dict[str, Any]) -> List[torch.Tensor]:
    """The parameter tensors in a fixed order (nested dicts flattened)."""
    out = []
    for name in sorted(params):
        value = params[name]
        out += param_leaves(value) if isinstance(value, dict) else [value]
    return out


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """The L2 norm of all the tensors together, in fp32 (a device scalar)."""
    return torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(t, dtype=torch.float32) for t in tensors]))


@dataclasses.dataclass
class OptState:
    """AdamW's moments (inside ``adamw``) and the number of updates applied."""

    adamw: torch.optim.AdamW
    count: int = 0


@dataclasses.dataclass(frozen=True)
class Optimizer:
    lr: float = 3e-4
    weight_decay: float = 0.1
    warmup: int = 100
    grad_clip: float = 1.0

    def learning_rate(self, count: int) -> float:
        """optax ``warmup_cosine_decay_schedule(0, lr, warmup,
        max(10·warmup, 1000))`` at update ``count``: linear from 0, then a
        cosine to 0 over the remaining decay steps, then 0."""
        if count < self.warmup:
            return self.lr * count / self.warmup
        decay = max(10 * self.warmup, 1000) - self.warmup
        t = min(count - self.warmup, decay)
        return self.lr * 0.5 * (1.0 + math.cos(math.pi * t / decay))

    def init(self, params: Dict[str, Any]) -> OptState:
        adamw = torch.optim.AdamW(param_leaves(params), lr=0.0, betas=(ADAM_B1, ADAM_B2),
                                  eps=ADAM_EPS, weight_decay=self.weight_decay)
        return OptState(adamw)

    def update(self, params: Dict[str, Any], opt_state: OptState) -> torch.Tensor:
        """Clip the gradients held in ``.grad`` by their global norm, then
        apply one AdamW update in place. Returns the norm before clipping
        (a device scalar: no host sync)."""
        grads = [p.grad for p in param_leaves(params)]
        gnorm = global_norm(grads)
        # optax: t / g_norm * max_norm where g_norm >= max_norm, else t.
        factor = torch.where(gnorm < self.grad_clip, torch.ones_like(gnorm),
                             self.grad_clip / gnorm)
        for g in grads:
            g.mul_(factor.to(g.dtype))
        for group in opt_state.adamw.param_groups:
            group["lr"] = self.learning_rate(opt_state.count)
        opt_state.adamw.step()
        opt_state.count += 1
        return gnorm


def make_optimizer(lr: float = 3e-4, weight_decay: float = 0.1, warmup: int = 100,
                   grad_clip: float = 1.0) -> Optimizer:
    return Optimizer(lr=lr, weight_decay=weight_decay, warmup=warmup, grad_clip=grad_clip)


def make_train_state(cfg: tf.TransformerConfig, generator: torch.Generator, device="cuda",
                     optimizer: Optional[Optimizer] = None) -> Tuple[Dict[str, Any], OptState]:
    """Random fp32 params (``tf.init_params``; ``generator`` lives on
    ``device``) that require grad, and the optimizer's state over them."""
    optimizer = optimizer or make_optimizer()
    params = tf.init_params(cfg, generator, device=device, dtype=torch.float32)
    for p in param_leaves(params):
        p.requires_grad_(True)
    return params, optimizer.init(params)


def make_train_step(cfg: tf.TransformerConfig, optimizer: Optional[Optimizer] = None) -> Callable:
    """``step(params, opt_state, batch) → (params, opt_state, {"loss",
    "grad_norm"})``: value and gradients of ``tf.loss_fn``, the global
    gradient norm before clipping, one optimizer update. ``batch`` is
    ``{"tokens": [b, s+1]}`` with an optional ``"mask"``. Params and
    optimizer state are updated in place (the reference donates them);
    the metrics are device scalars."""
    optimizer = optimizer or make_optimizer()

    def step(params, opt_state: OptState, batch):
        leaves = param_leaves(params)
        for p in leaves:
            p.grad = None
        loss = tf.loss_fn(params, batch, cfg)
        loss.backward()
        gnorm = optimizer.update(params, opt_state)
        for p in leaves:
            p.grad = None
        return params, opt_state, {"loss": loss.detach(), "grad_norm": gnorm}

    return step
