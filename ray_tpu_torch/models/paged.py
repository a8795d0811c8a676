"""Paged KV cache + batched decode for continuous-batching LLM serving.

Counterpart of ``ray_tpu/models/paged.py`` (held to it by
``tests/test_torch_paged.py``):

- **Physical cache**: one pool of fixed-size blocks per layer,
  ``[L, num_blocks, block_size, kv_heads, head_dim]``. Block 0 is a
  reserved trash block that idle decode slots harmlessly write to, so the
  decode step never branches on slot liveness.
- **In place**: every function here writes the pool by indexed assignment
  into the cache tensors it is given and returns that same dict. This
  takes the place of the reference's buffer donation: the pool is never
  copied, and device-side writes are ordered by the CUDA stream.
- **Block tables**: each decode slot owns a row ``[max_blocks_per_seq]``
  of physical block ids; the host allocator (``serve/llm_engine.py``)
  mutates them between steps.
- **Decode** (``paged_decode_step``): per layer, scatter the new K/V into
  (block, offset) slots, gather the slot's blocks back as a contiguous
  ``[b, W*bs, KV, HD]`` view and run grouped-GQA einsum attention under a
  per-slot length mask (plain fp32 einsums, as in the reference).
- **Prefill** (``paged_prefill``): full-attention forward over a padded
  prompt bucket (the flash kernel on CUDA), scattering each layer's roped
  K/V into the slot's blocks.
- **Chunk prefill** (``paged_prefill_chunk``): positions ``start ..
  start+C-1`` attend to the slot's resident blocks plus the chunk.

Sampling is on-device and per-slot (greedy where ``temps == 0``, else
temperature-scaled categorical from an explicit ``torch.Generator``), so
one step moves only ``[b]`` tokens device→host.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from ray_tpu_torch.models.generate import categorical
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

PagedCache = Dict[str, torch.Tensor]

TRASH_BLOCK = 0  # physical block 0 is the write target for idle slots


@dataclasses.dataclass(frozen=True)
class PagedConfig:
    """Shape of the paged cache."""

    block_size: int = 16
    num_blocks: int = 64  # physical pool size, incl. the trash block
    max_batch: int = 8  # decode slots
    max_blocks_per_seq: int = 8  # block-table width W

    @property
    def max_seq_len(self) -> int:
        return self.block_size * self.max_blocks_per_seq

    @property
    def usable_blocks(self) -> int:
        return self.num_blocks - 1  # minus trash


def init_paged_cache(cfg: TransformerConfig, pcfg: PagedConfig, device="cuda") -> PagedCache:
    shape = (cfg.n_layers, pcfg.num_blocks, pcfg.block_size, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def _attend_paged(q, ck, cv, lens, cfg: TransformerConfig):
    """q: [b, H, HD] one token per slot; ck/cv: [b, m, KV, HD] gathered
    contiguous views; lens: [b] — position of the token just written
    (attend over positions <= lens, i.e. the prefix INCLUDING itself)."""
    b, H, HD = q.shape
    KV = cfg.n_kv_heads
    G = H // KV
    qg = q.reshape(b, KV, G, HD)
    scores = torch.einsum("bkgd,bmkd->bkgm", qg.float(), ck.float()) * (HD**-0.5)
    m = ck.shape[1]
    valid = torch.arange(m, device=q.device)[None, :] <= lens[:, None]  # [b, m]
    scores = scores.masked_fill(~valid[:, None, None, :], -1e30)
    probs = torch.softmax(scores, dim=-1)
    og = torch.einsum("bkgm,bmkd->bkgd", probs, cv.float())
    return og.reshape(b, H * HD).to(q.dtype)


def _paged_layer_step(x, lp: Params, cfg: TransformerConfig, ck, cv, tables, lens):
    """One layer, one token per slot.

    x: [b, 1, d]; ck/cv: [num_blocks, bs, KV, HD] (this layer's pool,
    written in place); tables: [b, W] physical block ids; lens: [b] write
    positions."""
    b = x.shape[0]
    bs = ck.shape[1]
    h = rms_norm(x, lp["attn_norm"])
    q, k, v = project_qkv(h, lp, cfg, lens[:, None])
    # Scatter the new K/V at (block, offset) per slot. Idle slots are
    # pointed at the trash block by the host allocator; their lens drift
    # past the table, so the block index is clamped (the reference's
    # out-of-range gather instead yields an index whose write is dropped).
    # Every entry of an idle row is the trash block, and live rows never
    # reach the clamp.
    W = tables.shape[1]
    phys = torch.gather(tables, 1, (lens // bs).clamp(max=W - 1)[:, None])[:, 0]  # [b]
    off = lens % bs
    ck[phys, off] = k[:, 0]
    cv[phys, off] = v[:, 0]
    # Gather each slot's blocks into a contiguous [b, W*bs, KV, HD] view
    # (post-scatter, so the just-written token attends to itself).
    KV, HD = cfg.n_kv_heads, cfg.head_dim
    ck_g = ck[tables].reshape(b, W * bs, KV, HD)
    cv_g = cv[tables].reshape(b, W * bs, KV, HD)
    o = _attend_paged(q[:, 0], ck_g, cv_g, lens, cfg)
    x = x + (o @ lp["wo"].to(o.dtype))[:, None, :]
    return mlp_block(x, lp, cfg)


@torch.no_grad()
def paged_decode_step(
    params: Params,
    cfg: TransformerConfig,
    tokens: torch.Tensor,  # [b] — the tokens AT positions ``lens``
    cache: PagedCache,
    tables: torch.Tensor,  # [b, W]
    lens: torch.Tensor,  # [b]
) -> Tuple[torch.Tensor, PagedCache]:
    """One decode iteration over all slots → (logits [b, V] fp32, cache
    updated in place)."""
    x = embed(params, tokens[:, None], cfg)
    for i in range(cfg.n_layers):
        x = _paged_layer_step(x, layer_params(params, i), cfg, cache["k"][i], cache["v"][i],
                              tables, lens)
    return unembed(params, x, cfg)[:, 0], cache


def sample_tokens(logits: torch.Tensor, temps: torch.Tensor, generator: torch.Generator):
    """Per-slot sampling: greedy where temps == 0, else categorical at
    that slot's temperature. logits: [b, V] fp32; temps: [b] fp32."""
    greedy = torch.argmax(logits, dim=-1)
    safe_t = torch.where(temps > 0, temps, torch.ones_like(temps))[:, None]
    sampled = categorical(logits / safe_t, generator)
    return torch.where(temps > 0, sampled, greedy)


@torch.no_grad()
def paged_decode_loop(
    params: Params,
    cfg: TransformerConfig,
    tokens: torch.Tensor,  # [b] — tokens AT positions ``lens``
    cache: PagedCache,
    tables: torch.Tensor,  # [b, W] — FIXED across the window
    lens: torch.Tensor,  # [b]
    temps: torch.Tensor,  # [b]
    generator: torch.Generator,
    n_steps: int,
) -> Tuple[torch.Tensor, PagedCache]:
    """``n_steps`` decode iterations, feeding each step's sampled tokens to
    the next without a host sync. Every slot's block table must cover
    positions ``lens .. lens+n_steps-1``. Returns ([n_steps, b] sampled
    tokens, cache)."""
    seq = []
    for _ in range(n_steps):
        logits, cache = paged_decode_step(params, cfg, tokens, cache, tables, lens)
        tokens = sample_tokens(logits, temps, generator)
        lens = lens + 1
        seq.append(tokens)
    return torch.stack(seq), cache


@torch.no_grad()
def paged_prefill(
    params: Params,
    cfg: TransformerConfig,
    tokens: torch.Tensor,  # [1, S], S a multiple of block_size (padded)
    cache: PagedCache,
    block_row: torch.Tensor,  # [S // block_size] physical block ids
    block_size: int,
) -> Tuple[torch.Tensor, PagedCache]:
    """Full-attention prefill of ONE slot, scattering K/V into its blocks.

    Returns (logits [S, V] fp32, cache). Padded tail positions hold
    garbage K/V inside the last real block; they are masked by the length
    mask during decode and overwritten as the sequence grows."""
    b, S = tokens.shape
    if b != 1 or S % block_size:
        raise ValueError(f"paged_prefill takes [1, S] with S % {block_size} == 0, got {tuple(tokens.shape)}")
    positions = torch.arange(S, device=tokens.device)[None, :]
    KV, HD = cfg.n_kv_heads, cfg.head_dim
    nb = S // block_size
    h = embed(params, tokens, cfg)
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        h, k, v = attention_block(h, lp, cfg, positions, return_kv=True)
        h = mlp_block(h, lp, cfg)
        # [1, S, KV, HD] → [S//bs, bs, KV, HD] rows into the slot's blocks.
        cache["k"][i][block_row] = k.reshape(nb, block_size, KV, HD)
        cache["v"][i][block_row] = v.reshape(nb, block_size, KV, HD)
    return unembed(params, h, cfg)[0], cache


def prefill_and_sample(
    params, cfg: TransformerConfig, tokens, cache, block_row, block_size: int,
    real_len: int, temp: torch.Tensor, generator: torch.Generator,
):
    """Prefill one slot and sample its first generated token on-device.

    real_len: the unpadded prompt length; the sampled token continues from
    position real_len - 1. temp: 0-d fp32 tensor."""
    logits, cache = paged_prefill(params, cfg, tokens, cache, block_row, block_size)
    tok = sample_tokens(logits[real_len - 1][None, :], temp.reshape(1), generator)[0]
    return tok, cache


def _attend_chunk(q, ck, cv, qpos, cfg: TransformerConfig):
    """q: [C, H, HD] chunk queries; ck/cv: [m, KV, HD] the slot's gathered
    block view (prefix + this chunk, post-scatter); qpos: [C] absolute
    positions — attend over cache positions <= qpos (causal, prefix
    inclusive). Same fp32 einsum/softmax math as ``_attend_paged``."""
    C, H, HD = q.shape
    KV = cfg.n_kv_heads
    G = H // KV
    qg = q.reshape(C, KV, G, HD)
    scores = torch.einsum("ckgd,mkd->ckgm", qg.float(), ck.float()) * (HD**-0.5)
    m = ck.shape[0]
    valid = torch.arange(m, device=q.device)[None, :] <= qpos[:, None]  # [C, m]
    scores = scores.masked_fill(~valid[:, None, None, :], -1e30)
    probs = torch.softmax(scores, dim=-1)
    og = torch.einsum("ckgm,mkd->ckgd", probs, cv.float())
    return og.reshape(C, H * HD).to(q.dtype)


@torch.no_grad()
def paged_prefill_chunk(
    params: Params,
    cfg: TransformerConfig,
    tokens: torch.Tensor,  # [1, C], C a multiple of block_size (padded)
    cache: PagedCache,
    table_row: torch.Tensor,  # [W] — the slot's FULL block table
    chunk_row: torch.Tensor,  # [C // block_size] — blocks receiving this chunk
    block_size: int,
    start: int,  # absolute position of tokens[0, 0]
) -> Tuple[torch.Tensor, PagedCache]:
    """Prefill positions ``start .. start+C-1`` of ONE slot, attending to
    the slot's already-resident KV blocks (prefix-cache hits or earlier
    chunks) plus the chunk itself: scatter the chunk's K/V into
    ``chunk_row`` and attend through the gathered ``table_row`` view under
    a causal position mask. Returns (logits [C, V] fp32, cache)."""
    b, C = tokens.shape
    if b != 1 or C % block_size:
        raise ValueError(f"paged_prefill_chunk takes [1, C] with C % {block_size} == 0, got {tuple(tokens.shape)}")
    W = table_row.shape[0]
    KV, HD = cfg.n_kv_heads, cfg.head_dim
    nb = C // block_size
    positions = start + torch.arange(C, device=tokens.device)[None, :]  # [1, C]
    x = embed(params, tokens, cfg)
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        ck, cv = cache["k"][i], cache["v"][i]
        h = rms_norm(x, lp["attn_norm"])
        q, k, v = project_qkv(h, lp, cfg, positions)
        # Scatter the chunk's K/V block-rows into the pool (padded tail
        # rows point at the trash block via chunk_row).
        ck[chunk_row] = k[0].reshape(nb, block_size, KV, HD)
        cv[chunk_row] = v[0].reshape(nb, block_size, KV, HD)
        ck_g = ck[table_row].reshape(W * block_size, KV, HD)
        cv_g = cv[table_row].reshape(W * block_size, KV, HD)
        o = _attend_chunk(q[0], ck_g, cv_g, positions[0], cfg)
        x = x + (o @ lp["wo"].to(o.dtype))[None]
        x = mlp_block(x, lp, cfg)
    return unembed(params, x, cfg)[0], cache


def prefill_chunk_and_sample(
    params, cfg: TransformerConfig, tokens, cache, table_row, chunk_row,
    block_size: int, start: int, last_idx: int, temp: torch.Tensor,
    generator: torch.Generator,
):
    """Chunk prefill + on-device sampling at ``last_idx`` (chunk-relative
    position of the prompt's final token, clamped by the caller). The
    sampled token is only meaningful on the prompt's FINAL chunk."""
    logits, cache = paged_prefill_chunk(
        params, cfg, tokens, cache, table_row, chunk_row, block_size, start
    )
    tok = sample_tokens(logits[last_idx][None, :], temp.reshape(1), generator)[0]
    return tok, cache
