"""ray_tpu_torch.serve.llm_engine: the paged continuous-batching engine.

Greedy engine tokens are held to the PORT's own contiguous-cache
``generate`` (same math, different memory layout and scheduling), not to
the reference engine's tokens, whose token-for-token tests are unsteady
on this CPU backend. The slice as a whole is held to JAX through the
first generated token of each request (``prefill_and_sample`` on the same
weights). Allocator and prefix-cache invariants mirror
``tests/test_prefix_cache.py``.
"""
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import paged as jpg
from ray_tpu.models import transformer as jtf
from ray_tpu_torch.models import transformer as ttf
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.models.generate import generate
from ray_tpu_torch.models.paged import TRASH_BLOCK, PagedConfig
from ray_tpu_torch.serve.llm_engine import LLMEngine, _BlockAllocator, _PrefixCache


@pytest.fixture(scope="module")
def tiny_model():
    jcfg = jtf.TransformerConfig.tiny(dtype=jnp.float32, remat=False)
    tcfg = ttf.TransformerConfig.tiny(dtype=torch.float32, remat=False)
    jp = jtf.init_params(jax.random.PRNGKey(7), jcfg)
    tp = params_from_jax(jax.device_get(jp), device="cpu")
    return tcfg, tp, jcfg, jp


@pytest.fixture(autouse=True)
def _single_thread():
    """One intra-op thread: the token-for-token comparisons then do not
    depend on the machine's core count."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _engine(cfg, params, **kw):
    pcfg_kw = dict(block_size=8, num_blocks=33, max_batch=4, max_blocks_per_seq=8)
    for k in list(kw):
        if k in pcfg_kw:
            pcfg_kw[k] = kw.pop(k)
    return LLMEngine(params, cfg, PagedConfig(**pcfg_kw), device="cpu", **kw)


def _reference(cfg, params, prompt, n):
    return generate(params, cfg, torch.tensor([prompt]), n)[0].tolist()


SHARED = [7, 3, 9, 1, 4, 6, 2, 8, 11, 12, 13, 14, 15, 16, 17, 18, 21, 22, 23, 24]
PROMPTS = [[5, 9, 2], [17, 1, 8, 4], [30, 31], [7, 6, 5, 4, 3]]


def _cache_invariants(eng):
    """No block may be simultaneously free, cached, and/or slot-owned."""
    pc = eng.prefix_cache
    assert len(eng.alloc.free) == len(set(eng.alloc.free)), "double-freed block"
    free = set(eng.alloc.free)
    cached = set(pc.meta)
    in_use = {b for bl in eng.slot_blocks for b in bl}
    assert not free & cached, "block both free and cache-resident"
    assert TRASH_BLOCK not in free and TRASH_BLOCK not in cached
    for bid, (_key, _parent, refs) in pc.meta.items():
        mapped = sum(bl.count(bid) for bl in eng.slot_blocks)
        assert refs == mapped, f"block {bid}: refs {refs} != mapped {mapped}"
        if refs == 0:
            assert bid in pc.lru and bid not in in_use
    owned_or_resident = len(free) + len(pc.lru) + len(in_use - cached) + len(in_use & cached)
    assert owned_or_resident == eng.pcfg.usable_blocks


@pytest.mark.parametrize("window,overlap", [(1, False), (4, False), (1, True), (4, True)],
                         ids=["w1", "w4", "w1_overlap", "w4_overlap"])
def test_engine_matches_contiguous_generate(tiny_model, window, overlap):
    cfg, params, *_ = tiny_model
    eng = _engine(cfg, params, max_batch=2, decode_window=window, overlap=overlap)
    outs = eng.generate_batch(PROMPTS, max_new_tokens=13)
    for p, o in zip(PROMPTS, outs):
        assert o == _reference(cfg, params, p, 13), f"prompt {p}"
    # 2 slots served 4 requests → retirement + refill at window seams.
    assert eng.stats["prefills"] == 4 and eng.stats["max_active"] == 2
    assert eng.stats["full_prefills"] == 4
    if overlap:
        assert eng.stats["spec_windows"] > 0


def test_idle_rows_drift_past_their_table(tiny_model):
    """An idle slot's lens advance every window until it is reused; once
    past its 2-block table (16 positions) its writes must still land in
    the trash block and leave the live slot's output untouched."""
    cfg, params, *_ = tiny_model
    eng = _engine(cfg, params, num_blocks=9, max_batch=2, max_blocks_per_seq=2)
    for p in PROMPTS[:3]:  # serial: slot 0 serves, slot 1 stays idle
        assert eng.generate_batch([p], 10) == [_reference(cfg, params, p, 10)]
    assert eng.lens[1] > eng.pcfg.max_seq_len
    assert eng.alloc.available == eng.pcfg.usable_blocks


@pytest.mark.parametrize("window,overlap", [(1, False), (4, True)], ids=["w1", "w4_overlap"])
def test_eos_stops_exactly_at_eos(tiny_model, window, overlap):
    cfg, params, *_ = tiny_model
    ref = _reference(cfg, params, PROMPTS[0], 12)
    k = next(k for k in range(1, 12) if ref.index(ref[k]) == k)  # first occurrence mid-stream
    eng = _engine(cfg, params, decode_window=window, overlap=overlap)
    [out] = eng.generate_batch([PROMPTS[0]], max_new_tokens=12, eos_id=ref[k])
    assert out == ref[: k + 1]


def test_preemption_recompute_matches(tiny_model):
    """A pool too small for all sequences forces eviction; evicted requests
    resume via re-prefill and finish with the unpressured output."""
    cfg, params, *_ = tiny_model
    prompts = [[i + 1, i + 2, i + 3, i + 4] for i in range(4)]
    eng = _engine(cfg, params, num_blocks=13, max_batch=4, max_blocks_per_seq=4)
    outs = eng.generate_batch(prompts, max_new_tokens=28)
    assert eng.stats["preemptions"] > 0
    assert outs == [_reference(cfg, params, p, 28) for p in prompts]


def test_overlap_preemption_under_pressure(tiny_model):
    cfg, params, *_ = tiny_model
    prompts = [[i + 1, i + 2, i + 3, i + 4] for i in range(4)]
    eng = _engine(cfg, params, num_blocks=13, max_blocks_per_seq=4, decode_window=2, overlap=True)
    outs = eng.generate_batch(prompts, max_new_tokens=24)
    assert eng.stats["preemptions"] > 0
    assert outs == [_reference(cfg, params, p, 24) for p in prompts]


def test_prefix_cache_shared_prefixes(tiny_model):
    """Requests sharing a prefix give the plain outputs while their cached
    prompt tokens are not prefilled again; refcounts track sharing."""
    cfg, params, *_ = tiny_model
    prompts = [SHARED + [30 + i, 40 + i, 50 + i] for i in range(4)]
    eng = _engine(cfg, params, enable_prefix_cache=True)
    first = eng.generate_batch([prompts[0]], 8)
    rest = eng.generate_batch(prompts[1:], 8)  # concurrent: share the blocks
    assert first + rest == [_reference(cfg, params, p, 8) for p in prompts]
    s = eng.stats
    assert s["prefix_lookup_tokens"] == sum(len(p) for p in prompts)
    assert s["prefix_hit_tokens"] == 48  # 3 warm requests x 2 full shared blocks
    assert s["prompt_tokens"] == s["prefix_lookup_tokens"] - s["prefix_hit_tokens"]
    assert s["full_prefills"] == 1
    pc = eng.prefix_cache
    assert pc.resident_blocks == 2 and pc.evictable_blocks == 2
    _cache_invariants(eng)


def test_prefix_cache_exact_repeat_keeps_one_suffix_token(tiny_model):
    """A block-aligned prompt seen before hits all but its last block: at
    least one token must be prefilled to sample the first output."""
    cfg, params, *_ = tiny_model
    p = SHARED[:16]
    eng = _engine(cfg, params, enable_prefix_cache=True)
    expect = [_reference(cfg, params, p, 6)]
    assert eng.generate_batch([p], 6) == expect
    assert eng.generate_batch([p], 6) == expect
    assert eng.stats["prefix_hit_tokens"] == 8 and eng.stats["prefill_chunks"] == 1
    _cache_invariants(eng)


def test_prefix_cache_eviction_no_stale_aliasing(tiny_model):
    cfg, params, *_ = tiny_model
    eng = _engine(cfg, params, enable_prefix_cache=True, num_blocks=13, max_batch=2,
                  max_blocks_per_seq=6)
    first = list(range(1, 18))
    others = [[i + 20] * 17 for i in range(6)]
    expect_first = _reference(cfg, params, first, 6)
    assert eng.generate_batch([first], 6) == [expect_first]
    for p in others:
        assert eng.generate_batch([p], 6) == [_reference(cfg, params, p, 6)]
        _cache_invariants(eng)
    assert eng.stats["prefix_evictions"] > 0
    assert eng.generate_batch([first], 6) == [expect_first]  # recomputed, not stale
    _cache_invariants(eng)


def test_prefix_cache_preempt_resume_hits(tiny_model):
    cfg, params, *_ = tiny_model
    prompts = [[i + 1, i + 2, i + 3, i + 4] * 2 for i in range(4)]
    eng = _engine(cfg, params, enable_prefix_cache=True, num_blocks=13, max_blocks_per_seq=6)
    outs = eng.generate_batch(prompts, 28)
    assert outs == [_reference(cfg, params, p, 28) for p in prompts]
    assert eng.stats["preemptions"] > 0 and eng.stats["prefix_hit_tokens"] > 0
    _cache_invariants(eng)


def test_chunked_prefill_matches_and_interleaves(tiny_model):
    """A long prompt split into chunks decodes identically, and a short
    stream keeps producing tokens between the long prompt's chunks."""
    cfg, params, *_ = tiny_model
    long_p, short_p = list(range(1, 49)), [9, 8, 7]
    eng = _engine(cfg, params, prefill_chunk=8)
    short_req = eng.add_request(short_p, 12)
    eng.step()
    long_req = eng.add_request(long_p, 8)
    chunks_when_short_progressed = None
    while eng.active_count() or eng.waiting:
        eng.step()
        if chunks_when_short_progressed is None and short_req.out.qsize() > 2:
            chunks_when_short_progressed = eng.stats["prefill_chunks"]
    assert list(long_req.tokens(timeout=60)) == _reference(cfg, params, long_p, 8)
    assert list(short_req.tokens(timeout=60)) == _reference(cfg, params, short_p, 12)
    assert eng.stats["prefill_chunks"] >= 6
    assert chunks_when_short_progressed is not None and chunks_when_short_progressed < 6


def test_chunked_prefill_with_cache_and_overlap(tiny_model):
    cfg, params, *_ = tiny_model
    prompts = [SHARED + SHARED[:12] + [70 + i] for i in range(4)]  # 33 tokens
    eng = _engine(cfg, params, enable_prefix_cache=True, prefill_chunk=16, overlap=True,
                  decode_window=2)
    outs = [eng.generate_batch([p], 6)[0] for p in prompts]
    assert outs == [_reference(cfg, params, p, 6) for p in prompts]
    assert eng.stats["prefill_chunks"] > 0 and eng.stats["prefix_hit_tokens"] > 0
    _cache_invariants(eng)


def test_warmup_buckets_touch_only_the_trash_block(tiny_model):
    cfg, params, *_ = tiny_model
    eng = _engine(cfg, params, warmup_buckets=True, enable_prefix_cache=True)
    # tiny: buckets 8..64 (4 prefill + 4 suffix-chunk) + decode = 9.
    assert eng.stats["warmup_compiles"] == 9 and eng.stats["warmup_s"] >= 0
    assert eng.alloc.available == eng.pcfg.usable_blocks
    assert eng.cache["k"][:, 1:].abs().sum() == 0  # only block 0 written
    assert eng.generate_batch(PROMPTS[:2], 8) == [_reference(cfg, params, p, 8) for p in PROMPTS[:2]]


def test_dirty_slot_shipping_skips_stable_arrays(tiny_model):
    cfg, params, *_ = tiny_model
    eng = _engine(cfg, params)
    eng.generate_batch([[5, 9, 2]], max_new_tokens=24)
    s = eng.stats
    assert s["h2d_skips"] > 0 and s["h2d_ships"] < 4 * s["steps"] / 2


def test_capacity_rejections(tiny_model):
    cfg, params, *_ = tiny_model
    eng = _engine(cfg, params)  # max_seq_len = 64
    free_before = eng.alloc.available
    with pytest.raises(RuntimeError, match="exceeds capacity"):
        list(eng.add_request([1] * 60, max_new_tokens=10).tokens(timeout=5))
    with pytest.raises(RuntimeError, match="non-empty"):
        list(eng.add_request([], max_new_tokens=4).tokens(timeout=5))
    assert eng.alloc.available == free_before
    # Overlap doubles the overshoot margin: 30 + 28 + 7 > 64 is refused.
    eng_o = _engine(cfg, params, decode_window=4, overlap=True)
    with pytest.raises(RuntimeError, match="exceeds capacity"):
        list(eng_o.add_request([1] * 30, max_new_tokens=28).tokens(timeout=5))
    assert len(eng_o.generate_batch([[1] * 30], 27)[0]) == 27


def test_streaming_two_clients_share_one_batch(tiny_model):
    cfg, params, *_ = tiny_model
    eng = _engine(cfg, params)
    eng.start()
    try:
        results = {}

        def client(name, prompt):
            req = eng.add_request(prompt, max_new_tokens=16)
            results[name] = [(t, time.monotonic()) for t in req.tokens(timeout=60)]

        threads = [threading.Thread(target=client, args=("a", [2, 4, 6])),
                   threading.Thread(target=client, args=("b", [1, 3, 5, 7]))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        assert len(results["a"]) == 16 and len(results["b"]) == 16
        assert eng.stats["max_active"] == 2
        assert [t for t, _ in results["a"]] == _reference(cfg, params, [2, 4, 6], 16)
    finally:
        eng.stop()
    assert eng._thread is None


def test_report_state_and_latency_summary(tiny_model):
    cfg, params, *_ = tiny_model
    eng = _engine(cfg, params, enable_prefix_cache=True, metrics_tags={"deployment": "d"})
    eng.generate_batch(PROMPTS, 5)
    snap = eng.report_state()
    assert snap["stats"]["finished"] == 4 and snap["tags"] == {"deployment": "d"}
    assert snap["occupancy"]["active"] == 0 and snap["prefix_cache"]["enabled"]
    lat = snap["latency_ms"]
    assert lat["ttft_ms"]["count"] == 4 and lat["tpot_ms"]["p50"] > 0
    assert len(snap["recent_requests"]) == 4 and snap["steps"]


def test_allocator_and_prefix_cache_units():
    """Allocator: alloc(0) is empty (not the whole list), the trash block
    is never handed out or freed. Prefix cache: evicting a parent evicts
    its cached descendants, so a reused parent id never re-links a stale
    child chain; a pinned descendant is unregistered but not freed."""
    alloc = _BlockAllocator(PagedConfig(num_blocks=5))
    assert alloc.alloc(0) == [] and alloc.available == 4
    got = alloc.alloc(4)
    assert sorted(got) == [1, 2, 3, 4] and alloc.alloc(1) is None
    alloc.release(got + [TRASH_BLOCK])
    assert alloc.available == 4 and TRASH_BLOCK not in alloc.free

    pc = _PrefixCache()
    a = pc.register(_PrefixCache.ROOT, (1, 2), 10)
    b = pc.register(a, (3, 4), 11)
    c = pc.register(b, (5, 6), 12)
    assert (a, b, c) == (10, 11, 12)
    assert pc.register(_PrefixCache.ROOT, (1, 2), 99) == 10  # canonical on duplicate
    for bid in (10, 11, 12):
        pc.release(bid)
    assert pc.evictable_blocks == 3
    assert set(pc.evict_lru()) == {10, 11, 12}
    assert pc.resident_blocks == 0 and not pc.table
    pc.register(_PrefixCache.ROOT, (9, 9), 10)
    assert pc.match([1, 2, 3, 4], 2, 2) == [] and pc.match([9, 9, 3, 4], 2, 2) == [10]
    # Pinned child under an evictable parent: unregistered, not freed.
    pc.register(10, (7, 7), 20)  # refs 1 (pinned)
    pc.release(10)
    assert pc.evict_lru() == [10]
    assert 20 not in pc.meta and pc.match([9, 9, 7, 7], 2, 2) == []


def test_slice_first_tokens_match_jax(tiny_model):
    """The slice as a whole against JAX: each request's first generated
    token from the port's engine equals JAX ``prefill_and_sample`` (greedy)
    on the same weights and the same padded bucket."""
    cfg, params, jcfg, jp = tiny_model
    prompts = [[5, 9, 2, 11, 3], [17, 1, 8], list(range(40, 60)), [200, 201, 202, 203, 204, 205, 206, 207, 208]]
    eng = _engine(cfg, params)
    outs = eng.generate_batch(prompts, 3)
    jc = jpg.init_paged_cache(jcfg, jpg.PagedConfig(block_size=8, num_blocks=33, max_batch=4,
                                                    max_blocks_per_seq=8))
    with jax.default_matmul_precision("highest"):
        for p, o in zip(prompts, outs):
            S = eng._bucket(len(p))
            toks = np.zeros((1, S), np.int32)
            toks[0, : len(p)] = p
            row = np.zeros(S // 8, np.int32)
            tok, _ = jpg.prefill_and_sample(jp, jcfg, jnp.asarray(toks), jc, jnp.asarray(row), 8,
                                            jnp.int32(len(p)), jnp.float32(0.0),
                                            jax.random.PRNGKey(0))
            assert o[0] == int(tok), f"prompt {p}"
