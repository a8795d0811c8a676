"""Llama-style decoder-only transformer: forward, losses and remat.

Counterpart of ``ray_tpu/models/transformer.py``, held to it by
``tests/test_torch_transformer.py``. Parameters are a plain dict of
tensors with the JAX tree's names and layouts: layer weights are stacked
on a leading ``[n_layers]`` axis and projections are ``[in, out]``
(``h @ w``), so ``models/convert.py`` moves a JAX tree over without a
transpose. ``decoder_stack`` is a Python loop over the stacked layers
(the JAX ``lax.scan``), each layer wrapped in
``torch.utils.checkpoint`` under ``remat`` (the JAX ``jax.checkpoint``),
with the reference's three policies: "full", and the selective "dots"
and "attn" (``create_selective_checkpoint_contexts``).

Attention runs through ``ray_tpu_torch.ops.attention.flash_attention``
(the custom op ``ray_tpu_torch::flash_fwd`` and its backward; hand-written
kernels on CUDA tensors). The MLP is dense or Mixtral-style top-k MoE
with dense dispatch.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, Optional

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ray_tpu_torch.ops.attention import flash_attention

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 11008
    rope_theta: float = 10000.0
    max_seq_len: int = 4096
    dtype: torch.dtype = torch.bfloat16  # compute dtype
    # Recompute each layer in backward (``torch.utils.checkpoint``); only
    # under autograd, so inference never pays for it.
    remat: bool = True
    num_experts: int = 0  # 0 = dense MLP
    experts_per_token: int = 2
    # Blockwise cross-entropy chunk (tokens); 0 = materialize full logits.
    logits_chunk: int = 0
    # What remat recomputes (``decoder_stack``): "full" the whole layer;
    # "dots" all but the products without batch dims (the projections);
    # "attn" all but the flash-attention op.
    remat_policy: str = "full"
    # Kept for field parity: the layer loop here has nothing to unroll.
    scan_unroll: int = 1

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @classmethod
    def llama7b(cls, **kw):
        return cls(**{**dict(vocab_size=32000, d_model=4096, n_layers=32, n_heads=32,
                             n_kv_heads=32, d_ff=11008), **kw})

    @classmethod
    def tiny(cls, **kw):
        """Small config for tests."""
        return cls(**{**dict(vocab_size=256, d_model=64, n_layers=4, n_heads=4,
                             n_kv_heads=2, d_ff=128, max_seq_len=128), **kw})


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_params(
    cfg: TransformerConfig,
    generator: torch.Generator,
    device="cuda",
    dtype: torch.dtype = torch.float32,
) -> Params:
    """Random weights with the reference's shapes and scales: dense
    ``normal * fan_in**-0.5``, embedding std 1, norms 1. ``generator``
    must live on ``device``. The numbers differ from ``jax.random``'s;
    tests that compare the two packages convert one tree instead."""
    L, D, F = cfg.n_layers, cfg.d_model, cfg.d_ff
    H, KV, HD = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def norm_init(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    def dense_init(*shape, fan_in):
        w = torch.randn(shape, generator=generator, dtype=dtype, device=device)
        return w.mul_(fan_in**-0.5)

    layers = {
        "attn_norm": norm_init(L, D),
        "wq": dense_init(L, D, H * HD, fan_in=D),
        "wk": dense_init(L, D, KV * HD, fan_in=D),
        "wv": dense_init(L, D, KV * HD, fan_in=D),
        "wo": dense_init(L, H * HD, D, fan_in=H * HD),
        "mlp_norm": norm_init(L, D),
    }
    if cfg.num_experts:
        E = cfg.num_experts
        layers.update(
            router=dense_init(L, D, E, fan_in=D),
            w_gate=dense_init(L, E, D, F, fan_in=D),
            w_up=dense_init(L, E, D, F, fan_in=D),
            w_down=dense_init(L, E, F, D, fan_in=F),
        )
    else:
        layers.update(
            w_gate=dense_init(L, D, F, fan_in=D),
            w_up=dense_init(L, D, F, fan_in=D),
            w_down=dense_init(L, F, D, fan_in=F),
        )
    return {
        "embed": dense_init(cfg.vocab_size, D, fan_in=1),
        "layers": layers,
        "final_norm": norm_init(D),
        "lm_head": dense_init(D, cfg.vocab_size, fan_in=D),
    }


def layer_params(params: Params, i: int) -> Params:
    """Layer ``i``'s slice of the stacked ``[L, ...]`` weights (views).
    For inference; ``decoder_stack`` unbinds the stacks once instead."""
    return {name: w[i] for name, w in params["layers"].items()}


def unbind_layers(params: Params):
    """Every layer's weights as views, from ONE ``unbind`` per stacked
    weight. Indexing ``w[i]`` per layer would make autograd build a full
    ``[L, ...]`` zero tensor per layer per weight in backward; an unbind's
    backward is a single stack."""
    stacks = {name: w.unbind(0) for name, w in params["layers"].items()}
    n = len(next(iter(stacks.values())))
    return [{name: ws[i] for name, ws in stacks.items()} for i in range(n)]


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


def rms_norm(x, scale, eps: float = 1e-5):
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x.float() * torch.rsqrt(var + eps)).to(x.dtype) * scale.to(x.dtype)


def _rope(x, positions, theta: float):
    """x: [b, s, h, hd]; rotate pairs (llama convention: split halves)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    angles = positions[:, :, None].float() * freqs[None, None, :]  # [b, s, half]
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def project_qkv(h, lp: Params, cfg: TransformerConfig, positions):
    """Normed hidden → (roped q [b,s,H,hd], roped k [b,s,KV,hd], v)."""
    b, s, _ = h.shape
    H, KV, HD = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (h @ lp["wq"].to(h.dtype)).reshape(b, s, H, HD)
    k = (h @ lp["wk"].to(h.dtype)).reshape(b, s, KV, HD)
    v = (h @ lp["wv"].to(h.dtype)).reshape(b, s, KV, HD)
    return _rope(q, positions, cfg.rope_theta), _rope(k, positions, cfg.rope_theta), v


def attention_block(
    x,
    lp: Params,
    cfg: TransformerConfig,
    positions,
    attn_fn: Optional[Callable] = None,
    return_kv: bool = False,
):
    """x: [b, s, d]. ``attn_fn`` overrides the core attention; one with
    ``supports_gqa`` takes kv-head-width K/V, any other gets K/V repeated
    to the q-head count. With ``return_kv`` also returns the pre-repeat
    roped (k, v) ``[b, s, KV, hd]`` for KV-cache prefill."""
    b, s, d = x.shape
    H, KV, HD = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = rms_norm(x, lp["attn_norm"])
    q, k, v = project_qkv(h, lp, cfg, positions)
    kr, vr = k, v
    if attn_fn is not None and not getattr(attn_fn, "supports_gqa", False) and KV != H:
        kr = k.repeat_interleave(H // KV, dim=2)
        vr = v.repeat_interleave(H // KV, dim=2)
    # The kernel takes contiguous [b, heads, s, hd]; the transposes are views.
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, kr, vr))
    o = flash_attention(qt, kt, vt, True, None) if attn_fn is None else attn_fn(qt, kt, vt)
    o = o.transpose(1, 2).reshape(b, s, H * HD)
    out = x + o @ lp["wo"].to(o.dtype)
    if return_kv:
        return out, k, v
    return out


def mlp_block(x, lp: Params, cfg: TransformerConfig):
    h = rms_norm(x, lp["mlp_norm"])
    if cfg.num_experts:
        return x + _moe_mlp(h, lp, cfg)
    gate = torch.nn.functional.silu(h @ lp["w_gate"].to(h.dtype))
    up = h @ lp["w_up"].to(h.dtype)
    return x + (gate * up) @ lp["w_down"].to(h.dtype)


def _moe_mlp(h, lp: Params, cfg: TransformerConfig):
    """Mixtral-style top-k MoE with dense dispatch (every expert runs on
    every token; ``combine`` zeroes the unused ones), as the reference."""
    b, s, _ = h.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    logits = (h @ lp["router"].to(h.dtype)).float()  # [b, s, E]
    weights, idx = torch.topk(logits, K, dim=-1)
    weights = torch.softmax(weights, dim=-1)
    # combine[b, s, E]: weight of each expert for each token (0 if unused)
    combine = torch.zeros(b, s, E, dtype=torch.float32, device=h.device).scatter(-1, idx, weights)
    combine = combine.to(h.dtype)
    gate = torch.nn.functional.silu(torch.einsum("bsd,edf->bsef", h, lp["w_gate"].to(h.dtype)))
    up = torch.einsum("bsd,edf->bsef", h, lp["w_up"].to(h.dtype))
    expert_out = torch.einsum("bsef,efd->bsed", gate * up, lp["w_down"].to(h.dtype))
    return torch.einsum("bsed,bse->bsd", expert_out, combine)


def decoder_layer(x, lp: Params, cfg: TransformerConfig, positions, attn_fn=None):
    x = attention_block(x, lp, cfg, positions, attn_fn)
    return mlp_block(x, lp, cfg)


# ---------------------------------------------------------------------------
# Full forward
# ---------------------------------------------------------------------------


def embed(params: Params, tokens, cfg: TransformerConfig):
    """Gather, then cast: the reference casts the whole table first
    (``transformer.py:248``), so its embedding gradient is a bf16
    scatter-add where this one accumulates in fp32 (identical at fp32)."""
    return params["embed"][tokens].to(cfg.dtype)


def _dots_policy(ctx, op, *args, **kwargs):
    """``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``: save
    every product without batch dimensions. ``h @ w`` on a 3-D ``h`` (the
    attention and dense-MLP projections, the MoE router) reaches
    ``aten.mm``; an einsum
    without batch dims ("bsd,edf->bsef") reaches ``aten.bmm`` with a batch
    of 1, and one with batch dims ("bsef,efd->bsed" over e) a larger
    batch. Attention is the flash op, not a product, so it is recomputed,
    as the reference recomputes its ``pallas_call``."""
    if op is torch.ops.aten.mm.default or (
            op is torch.ops.aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _attn_policy(ctx, op, *args, **kwargs):
    """``save_only_these_names("attn_out")``: save the flash op's outputs.
    Both of them, o and lse, so that the backward launches no forward
    kernel (the reference names only o)."""
    if op is torch.ops.ray_tpu_torch.flash_fwd.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_REMAT_POLICIES = {"full": None, "dots": _dots_policy, "attn": _attn_policy}


def decoder_stack(params: Params, h, cfg: TransformerConfig, positions, attn_fn=None):
    """The layer loop; with ``cfg.remat`` under autograd each layer is
    recomputed in backward (non-reentrant checkpoint), wholly under
    ``remat_policy`` "full" and selectively under "dots" and "attn"."""
    remat = cfg.remat and torch.is_grad_enabled()
    kwargs = {}
    if cfg.remat:
        if cfg.remat_policy not in _REMAT_POLICIES:
            raise ValueError(
                f"remat_policy must be 'full', 'dots' or 'attn', got {cfg.remat_policy!r}")
        policy = _REMAT_POLICIES[cfg.remat_policy]
        if policy is not None:
            kwargs["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                                     policy)
    for lp in unbind_layers(params):
        if remat:
            h = checkpoint(decoder_layer, h, lp, cfg, positions, attn_fn, use_reentrant=False,
                           **kwargs)
        else:
            h = decoder_layer(h, lp, cfg, positions, attn_fn)
    return h


def unembed(params: Params, h, cfg: TransformerConfig):
    h = rms_norm(h, params["final_norm"])
    return (h @ params["lm_head"].to(h.dtype)).float()


def hidden_states(params: Params, tokens, cfg: TransformerConfig, attn_fn=None, positions=None):
    """tokens: [b, s] int → final hidden states [b, s, d] (pre-norm)."""
    if positions is None:
        b, s = tokens.shape
        positions = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
    h = embed(params, tokens, cfg)
    return decoder_stack(params, h, cfg, positions, attn_fn)


def forward(params: Params, tokens, cfg: TransformerConfig, attn_fn=None, positions=None):
    """tokens: [b, s] int → logits [b, s, vocab] fp32. Differentiable;
    inference callers run it under ``torch.no_grad``."""
    return unembed(params, hidden_states(params, tokens, cfg, attn_fn, positions), cfg)


def _masked_mean_nll(ll, mask):
    if mask is not None:
        return -(ll * mask).sum() / mask.sum().clamp_min(1)
    return -ll.mean()


def token_nll(logits, targets, mask=None):
    """Mean next-token negative log-likelihood, optionally mask-weighted."""
    logp = torch.log_softmax(logits, dim=-1)
    ll = logp.gather(-1, targets[..., None])[..., 0]
    return _masked_mean_nll(ll, mask)


def chunked_token_nll(params: Params, h, targets, cfg: TransformerConfig, mask=None,
                      chunk: int = 256):
    """Blockwise next-token NLL: the ``[b, s, vocab]`` logits are never
    materialized. Sequence chunks are unembedded, reduced to per-token
    log-likelihoods and discarded; each chunk is checkpointed, so backward
    recomputes its logits instead of keeping every chunk's softmax."""
    b, s, _ = h.shape
    pad = (-s) % chunk
    if pad:
        h = torch.nn.functional.pad(h, (0, 0, 0, pad))
        targets = torch.nn.functional.pad(targets, (0, pad))

    def chunk_ll(hc, tc):
        logp = torch.log_softmax(unembed(params, hc, cfg), dim=-1)
        return logp.gather(-1, tc[..., None])[..., 0]

    lls = []
    for c0 in range(0, s + pad, chunk):
        hc, tc = h[:, c0:c0 + chunk], targets[:, c0:c0 + chunk]
        if torch.is_grad_enabled():
            lls.append(checkpoint(chunk_ll, hc, tc, use_reentrant=False))
        else:
            lls.append(chunk_ll(hc, tc))
    return _masked_mean_nll(torch.cat(lls, dim=1)[:, :s], mask)


def loss_fn(params: Params, batch: Dict[str, Any], cfg: TransformerConfig, attn_fn=None,
            logits_chunk: Optional[int] = None):
    """batch: {"tokens": [b, s+1]} (optional "mask" [b, s+1]) → next-token
    cross-entropy. ``logits_chunk`` > 0 switches to the blockwise NLL (no
    full logits); defaults to ``cfg.logits_chunk``."""
    if logits_chunk is None:
        logits_chunk = cfg.logits_chunk
    tokens = batch["tokens"]
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    mask = batch.get("mask")
    mask = mask[:, 1:] if mask is not None else None
    if logits_chunk:
        h = hidden_states(params, inputs, cfg, attn_fn)
        return chunked_token_nll(params, h, targets, cfg, mask, chunk=logits_chunk)
    return token_nll(forward(params, inputs, cfg, attn_fn), targets, mask)


def param_shapes(cfg: TransformerConfig) -> Dict[str, Any]:
    """The parameter tree's shapes, from the config alone (no allocation)."""
    L, D, F, V = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size
    H, KV, HD, E = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.num_experts
    layers = {
        "attn_norm": (L, D), "wq": (L, D, H * HD), "wk": (L, D, KV * HD),
        "wv": (L, D, KV * HD), "wo": (L, H * HD, D), "mlp_norm": (L, D),
    }
    if E:
        layers.update(router=(L, D, E), w_gate=(L, E, D, F), w_up=(L, E, D, F),
                      w_down=(L, E, F, D))
    else:
        layers.update(w_gate=(L, D, F), w_up=(L, D, F), w_down=(L, F, D))
    return {"embed": (V, D), "layers": layers, "final_norm": (D,), "lm_head": (D, V)}


def num_params(cfg: TransformerConfig) -> int:
    shapes = param_shapes(cfg)
    leaves = [shapes["embed"], shapes["final_norm"], shapes["lm_head"], *shapes["layers"].values()]
    return sum(math.prod(s) for s in leaves)


def flops_per_token(cfg: TransformerConfig, seq_len: int) -> float:
    """Approximate training FLOPs/token (6·N params + attention term)."""
    attn = 12 * cfg.n_layers * cfg.d_model * seq_len  # fwd+bwd QK^T and PV
    return 6.0 * num_params(cfg) + attn
