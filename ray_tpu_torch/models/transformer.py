"""Llama-style decoder-only transformer (inference forward).

Counterpart of ``ray_tpu/models/transformer.py``, held to it by
``tests/test_torch_transformer.py``. Parameters are a plain dict of
tensors with the JAX tree's names and layouts: layer weights are stacked
on a leading ``[n_layers]`` axis and projections are ``[in, out]``
(``h @ w``), so ``models/convert.py`` moves a JAX tree over without a
transpose. ``decoder_stack`` is a Python loop over the stacked layers.

Attention runs through ``ray_tpu_torch.ops.attention.flash_attention``
(the Hopper kernel on CUDA tensors). This slice is inference only: remat,
the MoE MLP and the losses come with the training slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

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
    # Kept for field parity with the reference config; the inference
    # forward here never rematerialises.
    remat: bool = True
    num_experts: int = 0  # 0 = dense MLP (the only MLP this slice ports)
    experts_per_token: int = 2
    logits_chunk: int = 0
    remat_policy: str = "full"
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
    if cfg.num_experts:
        raise NotImplementedError("MoE layers are not ported yet")
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
        "w_gate": dense_init(L, D, F, fan_in=D),
        "w_up": dense_init(L, D, F, fan_in=D),
        "w_down": dense_init(L, F, D, fan_in=F),
    }
    return {
        "embed": dense_init(cfg.vocab_size, D, fan_in=1),
        "layers": layers,
        "final_norm": norm_init(D),
        "lm_head": dense_init(D, cfg.vocab_size, fan_in=D),
    }


def layer_params(params: Params, i: int) -> Params:
    """Layer ``i``'s slice of the stacked ``[L, ...]`` weights (views)."""
    return {name: w[i] for name, w in params["layers"].items()}


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
    if cfg.num_experts:
        raise NotImplementedError("MoE layers are not ported yet")
    h = rms_norm(x, lp["mlp_norm"])
    gate = torch.nn.functional.silu(h @ lp["w_gate"].to(h.dtype))
    up = h @ lp["w_up"].to(h.dtype)
    return x + (gate * up) @ lp["w_down"].to(h.dtype)


def decoder_layer(x, lp: Params, cfg: TransformerConfig, positions, attn_fn=None):
    x = attention_block(x, lp, cfg, positions, attn_fn)
    return mlp_block(x, lp, cfg)


# ---------------------------------------------------------------------------
# Full forward
# ---------------------------------------------------------------------------


def embed(params: Params, tokens, cfg: TransformerConfig):
    return params["embed"][tokens].to(cfg.dtype)


def decoder_stack(params: Params, h, cfg: TransformerConfig, positions, attn_fn=None):
    for i in range(cfg.n_layers):
        h = decoder_layer(h, layer_params(params, i), cfg, positions, attn_fn)
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


@torch.no_grad()
def forward(params: Params, tokens, cfg: TransformerConfig, attn_fn=None, positions=None):
    """tokens: [b, s] int → logits [b, s, vocab] fp32."""
    return unembed(params, hidden_states(params, tokens, cfg, attn_fn, positions), cfg)
