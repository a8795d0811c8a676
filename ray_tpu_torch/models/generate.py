"""Autoregressive inference: KV-cache prefill + single-token decode.

Counterpart of ``ray_tpu/models/generate.py`` (held to it by
``tests/test_torch_paged.py``), and the contiguous-cache anchor that the
paged engine's greedy tokens are held to.

- Cache layout ``[L, b, max_len, kv_heads, head_dim]``.
- ``prefill`` runs the normal full-attention forward (the flash kernel on
  CUDA) while collecting each layer's roped K/V into the cache.
- ``decode_step`` is a single-token step: roped q/k at ``pos``, written
  into the cache IN PLACE (the reference's ``dynamic_update_slice``), then
  grouped-GQA einsum attention against the cache under a position mask.
- ``generate`` = prefill + a Python loop of decode steps with greedy or
  temperature sampling (top-k / top-p filtering), randomness from an
  explicit ``torch.Generator``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ray_tpu_torch.models.transformer import (
    Params,
    TransformerConfig,
    attention_block,
    embed,
    layer_params,
    mlp_block,
    project_qkv,
    rms_norm,
    unembed,
)

Cache = Dict[str, torch.Tensor]


def init_kv_cache(cfg: TransformerConfig, batch: int, max_len: int, device="cuda") -> Cache:
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def _attend_cache(q, ck, cv, pos: int, cfg: TransformerConfig):
    """q: [b, 1, H, HD]; ck/cv: [b, max_len, KV, HD]; pos: int.

    Grouped-GQA einsum keeps the cache at kv-head width (no repeat)."""
    b, _, H, HD = q.shape
    KV = cfg.n_kv_heads
    G = H // KV
    qg = q.reshape(b, 1, KV, G, HD)
    scores = torch.einsum("bqkgd,bmkd->bqkgm", qg.float(), ck.float()) * (HD**-0.5)
    m = ck.shape[1]
    valid = torch.arange(m, device=q.device) <= pos  # causal over the filled prefix
    scores = scores.masked_fill(~valid, -1e30)
    probs = torch.softmax(scores, dim=-1)
    og = torch.einsum("bqkgm,bmkd->bqkgd", probs, cv.float())
    return og.reshape(b, 1, H * HD).to(q.dtype)


def _decoder_layer_step(x, lp: Params, cfg: TransformerConfig, ck, cv, pos: int):
    """One layer, one token. x: [b, 1, d]; ck/cv (this layer's cache) are
    written in place at ``pos``."""
    b = x.shape[0]
    h = rms_norm(x, lp["attn_norm"])
    positions = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    q, k, v = project_qkv(h, lp, cfg, positions)
    ck[:, pos] = k[:, 0]
    cv[:, pos] = v[:, 0]
    o = _attend_cache(q, ck, cv, pos, cfg)
    x = x + o @ lp["wo"].to(o.dtype)
    return mlp_block(x, lp, cfg)


@torch.no_grad()
def decode_step(
    params: Params, cfg: TransformerConfig, tokens: torch.Tensor, cache: Cache, pos: int
) -> Tuple[torch.Tensor, Cache]:
    """tokens: [b] (the tokens AT position ``pos``) → (logits [b, V] fp32
    for the next position, the cache updated in place)."""
    x = embed(params, tokens[:, None], cfg)
    for i in range(cfg.n_layers):
        x = _decoder_layer_step(x, layer_params(params, i), cfg, cache["k"][i], cache["v"][i], pos)
    return unembed(params, x, cfg)[:, 0], cache


@torch.no_grad()
def prefill(
    params: Params, cfg: TransformerConfig, tokens: torch.Tensor, max_len: int
) -> Tuple[torch.Tensor, Cache]:
    """Full-attention prefill. tokens: [b, s] → (logits [b, s, V], cache
    with positions [0, s) filled)."""
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device)[None, :].expand(b, s)
    h = embed(params, tokens, cfg)
    cache = init_kv_cache(cfg, b, max_len, tokens.device)
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        h, k, v = attention_block(h, lp, cfg, positions, return_kv=True)
        h = mlp_block(h, lp, cfg)
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v
    return unembed(params, h, cfg), cache


def _filter_logits(logits: torch.Tensor, top_k: int, top_p: float) -> torch.Tensor:
    """Static-shape nucleus/top-k filtering: disallowed entries → -inf."""
    vocab = logits.shape[-1]
    if 0 < top_k < vocab:  # top_k >= vocab is a no-op, not an index error
        kth = torch.sort(logits, dim=-1).values[..., -top_k][..., None]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if 0.0 < top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep the smallest prefix with cumulative prob >= top_p (the
        # first token is always kept)
        keep = cum - probs < top_p
        cutoff = torch.where(keep, sorted_logits, torch.full_like(sorted_logits, float("inf")))
        cutoff = cutoff.amin(dim=-1, keepdim=True)
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    return logits


def categorical(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One sample per row of ``logits`` [..., V] (Gumbel-max; no host sync)."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_(min=1e-20, max=1.0 - 1e-7)))
    return torch.argmax(logits + gumbel, dim=-1)


@torch.no_grad()
def generate(
    params: Params,
    cfg: TransformerConfig,
    prompt: torch.Tensor,
    max_new_tokens: int,
    *,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Greedy (temperature=0) or sampled continuation with optional top-k /
    nucleus (top-p) filtering. prompt: [b, s] → generated tokens
    [b, max_new_tokens] (int64)."""
    b, s = prompt.shape
    if max_new_tokens <= 0:
        return torch.zeros((b, 0), dtype=torch.int64, device=prompt.device)
    if temperature > 0 and generator is None:
        raise ValueError("temperature > 0 requires an explicit torch.Generator")
    logits, cache = prefill(params, cfg, prompt, s + max_new_tokens)

    def sample(logits):
        if temperature > 0:
            return categorical(_filter_logits(logits, top_k, top_p) / temperature, generator)
        return torch.argmax(logits, dim=-1)

    tok = sample(logits[:, -1])
    out = [tok]
    for pos in range(s, s + max_new_tokens - 1):
        logits, cache = decode_step(params, cfg, tok, cache, pos)
        tok = sample(logits)
        out.append(tok)
    return torch.stack(out, dim=1)
