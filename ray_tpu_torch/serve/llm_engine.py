"""Continuous-batching LLM engine over the paged KV cache.

Counterpart of ``ray_tpu/serve/llm_engine.py``: the same host scheduler
with the same behaviour, driving ``ray_tpu_torch/models/paged.py``.
Iteration-level scheduling (Orca/vLLM): between every decode window the
host admits waiting requests into free slots, allocates KV blocks on
demand, and retires finished sequences.

Host/device split:
- Device: the ``paged`` functions, called directly (PyTorch runs eagerly;
  there are no compiled programs). Full-prompt prefill attention runs the
  flash kernel; decode and chunk attention are fp32 einsums. The KV pool
  is updated in place. Sampling is on-device from one ``torch.Generator``
  on the engine's device; a window moves only ``[window, b]`` tokens back.
- Host (this module): block free-list, slot assignment, preemption
  (recompute-on-resume, the vLLM default), per-request streaming queues.

Options (all opt-in, see ``__init__``): prefix-aware KV reuse
(``enable_prefix_cache``), chunked prefill (``prefill_chunk``),
host/device overlap (``overlap``), and bucket warmup
(``warmup_buckets``).

Overlap rides CUDA's stream order: a window is enqueued and returns at
once, its sampled tokens and advanced lens stay on the device and feed
the next window, and the harvest's ``.cpu()`` is the one host sync per
window. Host→device uploads go through pinned memory without a sync.

Not ported in this slice (they need the ray_tpu runtime): the metric
registry flush, tracing spans, and the controller push of
``report_state`` — which here returns its snapshot without pushing.

Threading: ``step()`` is single-threaded; ``start()`` runs it in a pump
thread so concurrent clients can stream while one engine drives the card.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import os
import queue
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ray_tpu_torch.models.paged import (
    TRASH_BLOCK,
    PagedConfig,
    init_paged_cache,
    paged_decode_loop,
    prefill_and_sample,
    prefill_chunk_and_sample,
)
from ray_tpu_torch.models.transformer import TransformerConfig
from ray_tpu_torch.serve.metrics import summarize_latencies

_req_ids = itertools.count()
_engine_ids = itertools.count()


@dataclasses.dataclass
class Request:
    """One generation request; ``out`` streams generated token ids and a
    final ``None`` sentinel."""

    prompt: List[int]
    max_new_tokens: int
    temperature: float = 0.0
    eos_id: Optional[int] = None
    rid: int = dataclasses.field(default_factory=lambda: next(_req_ids))
    out: "queue.Queue" = dataclasses.field(default_factory=queue.Queue)
    generated: List[int] = dataclasses.field(default_factory=list)
    # Set on rejection (prompt too long etc.); the sentinel is still sent.
    error: Optional[str] = None
    # Lifecycle marks (flight recorder + TTFT/TPOT accounting).
    submit_ts: float = dataclasses.field(default_factory=time.time)
    prefill_ts: Optional[float] = None
    first_token_ts: Optional[float] = None

    @property
    def remaining(self) -> int:
        return self.max_new_tokens - len(self.generated)

    @property
    def full_prompt(self) -> List[int]:
        """Prompt + everything generated so far — what a preempted
        request must re-prefill on resume (recompute policy)."""
        return self.prompt + self.generated

    def tokens(self, timeout: Optional[float] = None):
        """Iterate generated tokens until the sentinel (blocking)."""
        while True:
            tok = self.out.get(timeout=timeout)
            if tok is None:
                if self.error:
                    raise RuntimeError(self.error)
                return
            yield tok


class FlightRecorder:
    """Fixed-size rings of per-step and per-finished-request records,
    appended on the engine's single scheduler thread."""

    def __init__(self, step_capacity: int = 256, request_capacity: int = 256):
        self.steps: "collections.deque[dict]" = collections.deque(maxlen=step_capacity)
        self.requests: "collections.deque[dict]" = collections.deque(maxlen=request_capacity)

    def record_step(self, rec: dict):
        self.steps.append(rec)

    def record_request(self, rec: dict):
        self.requests.append(rec)

    def latency_summary(self) -> Dict[str, Dict[str, float]]:
        """p50/p95/p99 per latency field over the recent-request ring."""
        reqs = list(self.requests)
        return summarize_latencies({
            field: [r[field] for r in reqs if r.get(field) is not None]
            for field in ("queue_ms", "ttft_ms", "tpot_ms", "e2e_ms")
        })

    def snapshot(self) -> dict:
        return {
            "steps": list(self.steps),
            "recent_requests": list(self.requests),
            "latency_ms": self.latency_summary(),
        }


class _BlockAllocator:
    def __init__(self, pcfg: PagedConfig):
        # Block 0 is the trash block — never handed out.
        self.free = list(range(pcfg.num_blocks - 1, TRASH_BLOCK, -1))

    def alloc(self, n: int) -> Optional[List[int]]:
        if n <= 0:
            return []  # NOT free[-0:] — that slice is the whole list
        if len(self.free) < n:
            return None
        got, self.free = self.free[-n:], self.free[:-n]
        return got

    def release(self, blocks: Sequence[int]):
        self.free.extend(b for b in blocks if b != TRASH_BLOCK)

    @property
    def available(self) -> int:
        return len(self.free)


class _PrefixCache:
    """Refcounted index over prefill-resident KV blocks (vLLM automatic
    prefix caching).

    Each FULL prompt block is keyed by ``(parent_block_id, block_tokens)``
    — an exact-match chain, so a hit can never alias a different prefix.
    Blocks referenced by live slots are pinned (refs > 0); released blocks
    stay RESIDENT in an LRU of refcount-0 blocks and are only returned to
    the allocator when an allocation needs them (eviction cascades to
    cached descendants, since a re-used parent id must never re-link a
    stale child chain)."""

    ROOT = -1  # parent id for the first block of every prompt

    def __init__(self):
        # (parent_bid, tokens) -> bid; bid -> [key, parent, refs]
        self.table: Dict[tuple, int] = {}
        self.meta: Dict[int, list] = {}
        self.children: Dict[int, set] = {}
        # refcount-0 residents, coldest first (re-warmed on hit/release).
        self.lru: "collections.OrderedDict[int, None]" = collections.OrderedDict()

    @property
    def resident_blocks(self) -> int:
        return len(self.meta)

    @property
    def evictable_blocks(self) -> int:
        return len(self.lru)

    def match(self, tokens: Sequence[int], bs: int, limit: int) -> List[int]:
        """Longest cached chain of full blocks covering ``tokens`` (read
        only), capped at ``limit`` blocks so the caller always keeps >= 1
        suffix token to prefill."""
        bids: List[int] = []
        parent = self.ROOT
        for j in range(limit):
            bid = self.table.get((parent, tuple(tokens[j * bs:(j + 1) * bs])))
            if bid is None:
                break
            bids.append(bid)
            parent = bid
        return bids

    def incref(self, bid: int):
        m = self.meta[bid]
        m[2] += 1
        if m[2] == 1:
            self.lru.pop(bid, None)  # pinned — no longer evictable

    def release(self, bid: int) -> bool:
        """Drop one reference; returns False if the block isn't cache-
        managed (caller then frees it to the allocator). A block hitting
        refcount 0 stays resident as the WARMEST eviction candidate."""
        m = self.meta.get(bid)
        if m is None:
            return False
        m[2] -= 1
        if m[2] == 0:
            self.lru[bid] = None
        return True

    def register(self, parent: int, toks: tuple, bid: int) -> int:
        """Publish ``bid`` for (parent, toks) with one reference held by
        the registering slot; returns the canonical bid (the existing one
        on a concurrent-duplicate insert)."""
        key = (parent, toks)
        cur = self.table.get(key)
        if cur is not None:
            return cur
        self.table[key] = bid
        self.meta[bid] = [key, parent, 1]
        self.children.setdefault(parent, set()).add(bid)
        return bid

    def evict_lru(self) -> List[int]:
        """Evict the coldest refcount-0 block plus its cached descendants;
        returns the FREED block ids (empty if nothing is evictable).

        A descendant with refs > 0 (a private tail registered under a
        chain another request published) is UNREGISTERED but never freed
        here — its live slot still maps it and returns it to the allocator
        on release."""
        while self.lru:
            bid, _ = self.lru.popitem(last=False)
            if self.meta.get(bid, [None, None, -1])[2] != 0:
                continue  # defensive: stale entry
            freed: List[int] = []
            stack = [bid]
            while stack:
                b = stack.pop()
                m = self.meta.pop(b, None)
                if m is None:
                    continue
                key, parent, refs = m
                self.table.pop(key, None)
                self.children.get(parent, set()).discard(b)
                stack.extend(self.children.pop(b, ()))
                self.lru.pop(b, None)
                if refs == 0:
                    freed.append(b)
            return freed  # non-empty: the LRU root itself had refs == 0
        return []


@dataclasses.dataclass
class _ChunkState:
    """Progress of one slot's in-flight chunked prefill: positions
    ``[0, pos)`` of ``tokens`` are KV-resident (cache hits + completed
    chunks); the slot stays OUT of the decode set until pos == plen."""

    req: Request
    tokens: List[int]
    pos: int  # next absolute position to prefill (block-aligned)
    plen: int


class LLMEngine:
    """Continuous-batching engine for one model on one device."""

    def __init__(
        self,
        params,
        cfg: TransformerConfig,
        pcfg: Optional[PagedConfig] = None,
        *,
        device="cuda",
        decode_window: int = 1,
        seed: int = 0,
        metrics_tags: Optional[Dict[str, str]] = None,
        enable_prefix_cache: bool = False,
        prefill_chunk: Optional[int] = None,
        overlap: bool = False,
        warmup_buckets: bool = False,
    ):
        """``params``: the model weights on ``device`` — a dict of tensors,
        or a zero-arg callable returning one.

        ``decode_window``: decode steps per device call (one host sync per
        window). >1 trades per-token streaming granularity and up to
        window-1 wasted steps per finishing sequence for fewer syncs;
        scheduling happens at window boundaries.

        ``metrics_tags``: {deployment, replica} tags for ``report_state``.

        ``enable_prefix_cache``: keep refcounted prompt blocks resident
        after release and map them into later requests sharing the same
        prefix, so only the novel suffix is prefilled.

        ``prefill_chunk``: split prompts longer than this many tokens into
        fixed-size chunks interleaved with decode windows. Rounded up to a
        block multiple; None/0 = single-shot prefill.

        ``overlap``: dispatch window N+1 from window N's device-resident
        outputs BEFORE reading N's tokens. The capacity margin per request
        grows to 2*window-1.

        ``warmup_buckets``: run every prefill bucket (and the chunk/decode
        paths) once at build time, into the trash block; wall time lands
        in ``stats["warmup_s"]``."""
        self.cfg = cfg
        self.pcfg = pcfg or PagedConfig()
        p = self.pcfg
        self.device = torch.device(device)
        self.window = max(1, int(decode_window))
        self.overlap = bool(overlap)
        if prefill_chunk:
            # Chunks advance the block cursor: round to a block multiple.
            prefill_chunk = -(-int(prefill_chunk) // p.block_size) * p.block_size
            prefill_chunk = min(prefill_chunk, p.max_seq_len)
        self.prefill_chunk = int(prefill_chunk or 0)
        self.prefix_cache = _PrefixCache() if enable_prefix_cache else None
        self.params = params() if callable(params) else params
        self.cache = init_paged_cache(cfg, p, self.device)
        self.alloc = _BlockAllocator(p)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        # Slot state. Host-side numpy is the source of truth; the device
        # keeps mirrors (``_dev``) that are re-uploaded ONLY when the
        # scheduler dirtied them — steady-state decode re-ships nothing
        # (cur/lens ride the decode window's own outputs).
        self.slots: List[Optional[Request]] = [None] * p.max_batch
        self.slot_blocks: List[List[int]] = [[] for _ in range(p.max_batch)]
        # Bumped on every (re)assignment of a slot: an in-flight window's
        # lane is only harvested if the slot STILL holds the same
        # assignment.
        self._slot_gen = [0] * p.max_batch
        self.tables = np.full((p.max_batch, p.max_blocks_per_seq), TRASH_BLOCK, np.int64)
        self.lens = np.zeros(p.max_batch, np.int64)
        self.temps = np.zeros(p.max_batch, np.float32)
        self.cur = np.zeros(p.max_batch, np.int64)
        self._dev: Dict[str, Optional[torch.Tensor]] = {
            "tables": None, "lens": None, "temps": None, "cur": None,
        }
        self._dirty = {"tables", "lens", "temps", "cur"}
        # In-flight window: ([(slot, rid, gen), ...], seq device tensor).
        # Harvested (ONE host sync) at the top of the next step.
        self._inflight: Optional[tuple] = None
        # Slots mid-chunked-prefill (excluded from the decode set);
        # _chunk_rr rotates which slot advances each step.
        self._prefilling: Dict[int, _ChunkState] = {}
        self._chunk_rr = -1
        self.waiting: "collections.deque[Request]" = collections.deque()
        # Prefill first-tokens awaiting ONE batched device→host transfer.
        self._pending_first: List = []
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.stats = {"steps": 0, "tokens": 0, "max_active": 0, "preemptions": 0,
                      "prefills": 0, "full_prefills": 0, "admitted": 0,
                      "prompt_tokens": 0, "finished": 0, "prefill_chunks": 0,
                      "spec_windows": 0, "h2d_ships": 0, "h2d_skips": 0,
                      "prefix_hit_tokens": 0, "prefix_lookup_tokens": 0,
                      "prefix_evictions": 0}
        if warmup_buckets:
            t0 = time.perf_counter()
            self.stats["warmup_compiles"] = self._warmup()
            self.stats["warmup_s"] = round(time.perf_counter() - t0, 3)
        self.recorder = FlightRecorder()
        self.engine_id = next(_engine_ids)
        self.metrics_tags = dict(metrics_tags or {
            "deployment": "_standalone", "replica": f"pid{os.getpid()}",
        })

    # ------------------------------------------------------------------
    # Device calls
    # ------------------------------------------------------------------

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """Host array → a device tensor the host may mutate afterwards,
        without a stream sync on CUDA (pinned staging, async copy)."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.clone()

    def _temp(self, temperature: float) -> torch.Tensor:
        return torch.full((), float(temperature), dtype=torch.float32, device=self.device)

    def _prefill(self, toks: np.ndarray, row: np.ndarray, real_len: int, temperature: float):
        tok, self.cache = prefill_and_sample(
            self.params, self.cfg, self._upload(toks), self.cache, self._upload(row),
            self.pcfg.block_size, real_len, self._temp(temperature), self.gen,
        )
        return tok

    def _prefill_chunk_fn(self, toks, trow, crow, start: int, last_idx: int, temperature: float):
        tok, self.cache = prefill_chunk_and_sample(
            self.params, self.cfg, self._upload(toks), self.cache, self._upload(trow),
            self._upload(crow), self.pcfg.block_size, start, last_idx,
            self._temp(temperature), self.gen,
        )
        return tok

    def _decode(self, cur, tables, lens, temps):
        """One window → (seq [window, b], next-window tokens, advanced
        lens), all left on the device."""
        seq, self.cache = paged_decode_loop(
            self.params, self.cfg, cur, self.cache, tables, lens, temps, self.gen, self.window
        )
        return seq, seq[-1], lens + self.window

    def _warmup(self) -> int:
        """Run every shape the serving path can hit once: each prefill
        bucket, the chunk path (fixed chunk width, or every suffix bucket
        when the prefix cache may shorten prompts), and the decode window.
        All writes go to the trash block. Returns the number of runs."""
        p = self.pcfg
        bs = p.block_size
        sizes = []
        b = bs
        while b < p.max_seq_len:
            sizes.append(b)
            b *= 2
        sizes.append(p.max_seq_len)
        n = 0
        for S in sizes:
            self._prefill(np.zeros((1, S), np.int64), np.full(S // bs, TRASH_BLOCK, np.int64),
                          1, 0.0)
            n += 1
        if self.prefill_chunk:
            chunk_sizes = [self.prefill_chunk]
        elif self.prefix_cache is not None:
            chunk_sizes = sizes  # cache hits leave bucketed suffixes
        else:
            chunk_sizes = []
        trow = np.full(p.max_blocks_per_seq, TRASH_BLOCK, np.int64)
        for C in chunk_sizes:
            self._prefill_chunk_fn(np.zeros((1, C), np.int64), trow,
                                   np.full(C // bs, TRASH_BLOCK, np.int64), 0, 0, 0.0)
            n += 1
        seq, _cur, _lens = self._decode(
            self._upload(self.cur), self._upload(self.tables), self._upload(self.lens),
            self._upload(self.temps),
        )
        seq.cpu()
        return n + 1

    # ------------------------------------------------------------------
    # Public API
    # ------------------------------------------------------------------

    def add_request(
        self,
        prompt: Sequence[int],
        max_new_tokens: int,
        *,
        temperature: float = 0.0,
        eos_id: Optional[int] = None,
    ) -> Request:
        req = Request(list(prompt), max_new_tokens, temperature, eos_id)
        if not req.prompt:
            req.error = "prompt must be non-empty"
            req.out.put(None)
            return req
        # The decode window may overshoot a finishing sequence by up to
        # window-1 positions — one extra window with overlap; capacity
        # must cover the overshoot so those writes stay inside the slot's
        # own blocks.
        overshoot = self.window * (2 if self.overlap else 1) - 1
        total = len(req.prompt) + max_new_tokens + overshoot
        worst_blocks = -(-total // self.pcfg.block_size)
        if total > self.pcfg.max_seq_len or worst_blocks > self.pcfg.usable_blocks:
            req.error = (
                f"prompt({len(req.prompt)}) + max_new_tokens({max_new_tokens}) "
                f"(+ decode_window overshoot {overshoot}) exceeds capacity "
                f"(max_seq_len={self.pcfg.max_seq_len}, "
                f"usable_blocks={self.pcfg.usable_blocks})"
            )
            req.out.put(None)
            return req
        with self._lock:
            self.waiting.append(req)
        self._wake.set()
        return req

    def start(self):
        """Run the pump loop in a daemon thread."""
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            with torch.no_grad():
                while not self._stop.is_set():
                    if not self.step():
                        self._wake.wait(timeout=0.05)
                        self._wake.clear()

        self._thread = threading.Thread(target=loop, daemon=True, name="llm-engine")
        self._thread.start()

    def stop(self):
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def generate_batch(
        self,
        prompts: Sequence[Sequence[int]],
        max_new_tokens: int,
        *,
        temperature: float = 0.0,
        eos_id: Optional[int] = None,
    ) -> List[List[int]]:
        """Synchronous convenience: submit all, pump until done."""
        reqs = [
            self.add_request(p, max_new_tokens, temperature=temperature, eos_id=eos_id)
            for p in prompts
        ]
        if self._thread is None:
            while self.active_count() or self.waiting:
                self.step()
        return [list(r.tokens(timeout=120.0)) for r in reqs]

    def active_count(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    # ------------------------------------------------------------------
    # Scheduler internals
    # ------------------------------------------------------------------

    def _bucket(self, n: int) -> int:
        """Smallest block-multiple power-of-two bucket >= n (bounds the
        number of distinct prefill shapes)."""
        b = self.pcfg.block_size
        while b < n:
            b *= 2
        return min(b, self.pcfg.max_seq_len)

    def _free_slot(self, i: int):
        pc = self.prefix_cache
        if pc is None:
            self.alloc.release(self.slot_blocks[i])
        else:
            for b in self.slot_blocks[i]:
                # Cache-managed blocks stay RESIDENT (refcount drop, LRU
                # when unreferenced); private blocks go back to the pool.
                if not pc.release(b):
                    self.alloc.release((b,))
        self.slot_blocks[i] = []
        self.slots[i] = None
        self._prefilling.pop(i, None)
        self.tables[i] = TRASH_BLOCK
        self.lens[i] = 0
        self.temps[i] = 0.0
        self.cur[i] = 0
        self._dirty.update(("tables", "lens", "temps", "cur"))

    def _alloc_blocks(self, n: int) -> Optional[List[int]]:
        """Allocate ``n`` blocks, evicting cold prefix-cache residents as
        needed (LRU, refcount-0 only). None if even eviction can't cover."""
        if n <= 0:
            return []
        pc = self.prefix_cache
        while self.alloc.available < n and pc is not None and pc.evictable_blocks:
            freed = pc.evict_lru()
            if not freed:
                break
            self.alloc.release(freed)
            self.stats["prefix_evictions"] += len(freed)
        return self.alloc.alloc(n)

    def _finish(self, i: int):
        req = self.slots[i]
        self._free_slot(i)
        req.out.put(None)
        self.stats["finished"] += 1
        now = time.time()
        n = len(req.generated)
        self.recorder.record_request({
            "rid": req.rid,
            "ts": now,
            "prompt_tokens": len(req.prompt),
            "output_tokens": n,
            "queue_ms": (req.prefill_ts - req.submit_ts) * 1000.0
            if req.prefill_ts else None,
            "ttft_ms": (req.first_token_ts - req.submit_ts) * 1000.0
            if req.first_token_ts else None,
            "tpot_ms": (now - req.first_token_ts) * 1000.0 / (n - 1)
            if n > 1 and req.first_token_ts else None,
            "e2e_ms": (now - req.submit_ts) * 1000.0,
        })

    def _preempt_one(self) -> bool:
        """Evict the most-recently admitted slot (its prefix is shortest to
        recompute) and requeue it at the front; on resume its whole
        ``full_prompt`` is re-prefilled and generation continues."""
        victims = [i for i, s in enumerate(self.slots) if s is not None]
        if not victims:
            return False
        i = max(victims, key=lambda j: self.slots[j].rid)
        req = self.slots[i]
        self._free_slot(i)
        with self._lock:
            self.waiting.appendleft(req)
        self.stats["preemptions"] += 1
        return True

    def _ensure_decode_blocks(self) -> None:
        """Every active slot must own the blocks the coming window's
        writes land in (positions lens .. lens+window-1); allocate on
        demand, preempting if the pool is exhausted."""
        bs = self.pcfg.block_size
        for i in range(len(self.slots)):
            while self.slots[i] is not None and i not in self._prefilling:
                need_idx = (int(self.lens[i]) + self.window - 1) // bs
                if need_idx < len(self.slot_blocks[i]):
                    break  # this slot's window is covered
                got = self._alloc_blocks(1)
                if got is not None:
                    self.slot_blocks[i].append(got[0])
                    self.tables[i, len(self.slot_blocks[i]) - 1] = got[0]
                    self._dirty.add("tables")
                    continue
                # Pool exhausted: evict the youngest slot (possibly i
                # itself, in which case the outer while sees it freed).
                if not self._preempt_one():
                    return  # nothing evictable; retry next step

    def _admit(self):
        """Move waiting requests into free slots while blocks allow; a
        prefix-cache hit maps already-resident blocks into the slot's
        table and only the novel suffix is prefilled."""
        bs = self.pcfg.block_size
        while True:
            free_slots = [i for i, s in enumerate(self.slots) if s is None]
            if not free_slots:
                return
            with self._lock:
                if not self.waiting:
                    return
                req = self.waiting.popleft()
            full = req.full_prompt
            plen = len(full)
            real_blocks = -(-plen // bs)  # ceil
            hits: List[int] = []
            if self.prefix_cache is not None:
                # Pin hits BEFORE allocating — the allocation may evict
                # refcount-0 residents, which a matched block must not be.
                hits = self.prefix_cache.match(full, bs, (plen - 1) // bs)
                for b in hits:
                    self.prefix_cache.incref(b)
            got = self._alloc_blocks(real_blocks - len(hits))
            if got is None:
                for b in hits:
                    self.prefix_cache.release(b)
                with self._lock:
                    self.waiting.appendleft(req)
                return
            if self.prefix_cache is not None:
                self.stats["prefix_lookup_tokens"] += plen
                self.stats["prefix_hit_tokens"] += len(hits) * bs
            i = free_slots[0]
            self.slots[i] = req
            self._slot_gen[i] += 1
            self.slot_blocks[i] = hits + got
            self.stats["admitted"] += 1
            self._start_prefill(i, req, len(hits) * bs)

    def _start_prefill(self, i: int, req: Request, start: int):
        """Begin prefilling slot ``i`` from absolute position ``start``
        (block-aligned; positions below it are cache hits). Short work
        runs to completion now; prompts longer than ``prefill_chunk``
        enter the chunked queue and advance one chunk per step."""
        full = req.full_prompt
        plen = len(full)
        if req.prefill_ts is None:  # first admission (not a resume)
            req.prefill_ts = time.time()
        self.stats["prefills"] += 1
        self.stats["prompt_tokens"] += plen - start
        suffix = plen - start
        if self.prefill_chunk and suffix > self.prefill_chunk:
            self._prefilling[i] = _ChunkState(req, full, start, plen)
            return
        if start == 0:
            tok = self._run_full_prefill(i, req, full)
        else:
            # Suffix after a cache hit: one chunk call. Reuse the
            # configured chunk width when set; otherwise bucket the suffix.
            width = self.prefill_chunk or self._bucket(suffix)
            tok = self._run_chunk(i, req, full, start, width)
        self._finish_prefill(i, req, tok)

    def _advance_chunked_prefills(self):
        """ONE chunk of forward progress per step, round-robin across
        mid-prefill slots — the per-window decode stall is bounded by a
        single chunk's latency."""
        if not self._prefilling:
            return
        order = sorted(self._prefilling)
        i = next((j for j in order if j > self._chunk_rr), order[0])
        self._chunk_rr = i
        st = self._prefilling[i]
        tok = self._run_chunk(i, st.req, st.tokens, st.pos, self.prefill_chunk)
        st.pos += self.prefill_chunk
        if st.pos >= st.plen:
            del self._prefilling[i]
            self._finish_prefill(i, st.req, tok)

    def _run_full_prefill(self, i: int, req: Request, full: List[int]):
        """Whole-prompt full-attention prefill (bucketed) through the
        flash kernel; returns the first sampled token as a DEVICE scalar."""
        bs = self.pcfg.block_size
        plen = len(full)
        S = self._bucket(plen)
        toks = np.zeros((1, S), np.int64)
        toks[0, :plen] = full
        # Block row covers the padded bucket; entries past the real prompt
        # scatter into the trash block.
        row = np.full(S // bs, TRASH_BLOCK, np.int64)
        nreal = -(-plen // bs)
        row[:nreal] = self.slot_blocks[i]
        self.stats["full_prefills"] += 1
        return self._prefill(toks, row, plen, req.temperature)

    def _run_chunk(self, i: int, req: Request, full: List[int], start: int, width: int):
        """One chunk covering positions ``start .. start+width-1`` of slot
        ``i`` (attends to the slot's resident prefix); returns the sampled
        token (meaningful only when the chunk covers the final position)."""
        p = self.pcfg
        bs = p.block_size
        plen = len(full)
        end = min(start + width, plen)
        toks = np.zeros((1, width), np.int64)
        toks[0, : end - start] = full[start:end]
        blocks = self.slot_blocks[i]
        trow = np.full(p.max_blocks_per_seq, TRASH_BLOCK, np.int64)
        trow[: len(blocks)] = blocks
        crow = np.full(width // bs, TRASH_BLOCK, np.int64)
        b0 = start // bs
        for j in range(width // bs):
            if b0 + j < len(blocks):
                crow[j] = blocks[b0 + j]
        last_idx = min(max(plen - 1 - start, 0), width - 1)
        tok = self._prefill_chunk_fn(toks, trow, crow, start, last_idx, req.temperature)
        self.stats["prefill_chunks"] += 1
        return tok

    def _finish_prefill(self, i: int, req: Request, tok):
        """Prompt fully KV-resident: publish the slot to the decode set and
        queue the first sampled token for the batched flush."""
        full = req.full_prompt
        blocks = self.slot_blocks[i]
        self.tables[i] = TRASH_BLOCK
        self.tables[i, : len(blocks)] = blocks
        self.lens[i] = len(full)
        self.temps[i] = req.temperature
        self._dirty.update(("tables", "lens", "temps"))
        if self.prefix_cache is not None:
            self._register_prefix(full, blocks)
        self._pending_first.append((i, req, tok))

    def _register_prefix(self, full: List[int], blocks: List[int]):
        """Publish the slot's freshly-prefilled FULL blocks into the prefix
        index (the trailing partial block receives decode writes and is
        never shared)."""
        bs = self.pcfg.block_size
        pc = self.prefix_cache
        parent = _PrefixCache.ROOT
        for j in range(len(full) // bs):
            toks = tuple(full[j * bs:(j + 1) * bs])
            cur = pc.table.get((parent, toks))
            if cur is not None:
                parent = cur  # a hit we mapped, or a concurrent duplicate
                continue
            parent = pc.register(parent, toks, blocks[j])

    def _flush_prefills(self):
        if not self._pending_first:
            return
        pend, self._pending_first = self._pending_first, []
        vals = torch.stack([t for _, _, t in pend]).cpu().tolist()  # one transfer
        for (i, req, _), v in zip(pend, vals):
            if self.slots[i] is not req:
                continue  # preempted between prefill and flush
            self.cur[i] = int(v)
            self._dirty.add("cur")
            self._emit(i, int(v))

    def _emit(self, i: int, tok: int):
        """Record + stream one generated token; retire the slot when done."""
        req = self.slots[i]
        if req.first_token_ts is None:
            req.first_token_ts = time.time()
        req.generated.append(tok)
        req.out.put(tok)
        self.stats["tokens"] += 1
        if (req.eos_id is not None and tok == req.eos_id) or req.remaining <= 0:
            self._finish(i)

    def _ship(self) -> Dict[str, torch.Tensor]:
        """Device-resident decode inputs, re-uploading ONLY the arrays the
        scheduler dirtied since the last dispatch."""
        for name, host in (("tables", self.tables), ("lens", self.lens),
                           ("temps", self.temps), ("cur", self.cur)):
            if self._dev[name] is None or name in self._dirty:
                self._dev[name] = self._upload(host)
                self._dirty.discard(name)
                self.stats["h2d_ships"] += 1
            else:
                self.stats["h2d_skips"] += 1
        return self._dev

    def _decode_entries(self) -> List[tuple]:
        """(slot, rid, slot_gen) for every decodable slot — occupied and
        not mid-chunked-prefill."""
        return [(i, s.rid, self._slot_gen[i]) for i, s in enumerate(self.slots)
                if s is not None and i not in self._prefilling]

    def _dispatch_window(self, speculative: bool = False) -> bool:
        """Dispatch ONE decode window over the decodable slots without
        reading it back: outputs stay on the device and feed the next
        window. Host mirrors advance in lockstep (the window advances
        EVERY row; idle rows write to the trash block)."""
        self._ensure_decode_blocks()
        entries = self._decode_entries()
        if not entries:
            return False
        if speculative and "cur" in self._dirty:
            # The host ``cur`` mirror LAGS the in-flight window, so a dirty
            # cur must not be shipped wholesale now: it would rewind every
            # other slot by one window. Abort the speculation; the
            # synchronous path re-dispatches after the harvest.
            return False
        self.stats["max_active"] = max(self.stats["max_active"], len(entries))
        args = self._ship()
        seq, cur_out, lens_out = self._decode(args["cur"], args["tables"], args["lens"],
                                              args["temps"])
        self._dev["cur"] = cur_out
        self._dev["lens"] = lens_out
        self.lens += self.window
        if int(self.lens.max()) > (1 << 30):
            # Idle/prefilling rows drift +window per dispatch. Reset them
            # to 0 long before they could overflow.
            for i in range(len(self.slots)):
                if self.slots[i] is None or i in self._prefilling:
                    self.lens[i] = 0
            self._dirty.add("lens")
        self.stats["steps"] += 1
        self._inflight = (entries, seq)
        return True

    def _harvest(self) -> bool:
        if self._inflight is None:
            return False
        pending, self._inflight = self._inflight, None
        return self._harvest_window(pending)

    def _harvest_window(self, pending: tuple) -> bool:
        """Read one dispatched window's tokens (ONE host sync) and emit
        them. Slots freed/reused since dispatch fail the rid/generation
        check and their lanes are discarded (overshoot)."""
        entries, seq = pending
        nxt = seq.cpu().numpy()  # [window, b]
        for i, rid, gen in entries:
            req = self.slots[i]
            if req is None or req.rid != rid or self._slot_gen[i] != gen:
                continue  # finished / preempted / slot reused in flight
            for k in range(self.window):
                if self.slots[i] is not req:
                    break  # finished mid-window; rest is overshoot
                self.cur[i] = nxt[k, i]
                self._emit(i, int(nxt[k, i]))
        return True

    def _can_speculate(self) -> bool:
        """Dispatch window N+1 before reading window N's tokens? Not when a
        slot's cap-finish inside N is already certain, and not when an
        admission could use a free slot first."""
        entries = self._decode_entries()
        if not entries:
            return False
        if self.waiting and any(s is None for s in self.slots):
            return False
        if "cur" in self._dirty:
            return False  # host cur lags the in-flight window — sync first
        return all(self.slots[i].remaining > self.window for i, _, _ in entries)

    @torch.no_grad()
    def step(self) -> bool:
        """One scheduler iteration: [speculate] → harvest → admit → page →
        decode. Returns True if any device work ran (False = idle).

        With ``overlap`` window N+1 is enqueued from N's device-resident
        outputs BEFORE N's tokens are read; the stream orders every
        device-side write, so a freed block re-used by a later prefill is
        always overwritten AFTER the stale window's writes land."""
        keys = ("tokens", "prefills", "preemptions", "admitted", "prefill_chunks",
                "prefix_hit_tokens")
        s0 = tuple(self.stats[k] for k in keys)
        worked = False
        if self._inflight is not None:
            # Stash window N first: a speculated dispatch installs N+1 as
            # the new in-flight window, and N still owes its tokens.
            pending, self._inflight = self._inflight, None
            if self.overlap and self._can_speculate() and self._dispatch_window(speculative=True):
                self.stats["spec_windows"] += 1
            self._harvest_window(pending)
            worked = True
        self._admit()
        self._advance_chunked_prefills()
        self._flush_prefills()
        if self._inflight is None and self._dispatch_window():
            worked = True
            if not self.overlap:
                self._harvest()  # classic synchronous window
        s1 = tuple(self.stats[k] for k in keys)
        # Record even decode-less iterations that did work (e.g. a
        # max_new_tokens=1 request finishes inside the prefill flush).
        worked = worked or s1 != s0
        if worked:
            pc = self.prefix_cache
            self.recorder.record_step({
                "ts": time.time(),
                "active": self.active_count(),
                "waiting": len(self.waiting),
                "kv_blocks_free": self.alloc.available,
                "kv_utilization": 1.0 - self.alloc.available / max(1, self.pcfg.usable_blocks),
                "tokens": s1[0] - s0[0],
                "prefills": s1[1] - s0[1],
                "preemptions": s1[2] - s0[2],
                "admitted": s1[3] - s0[3],
                "chunks": s1[4] - s0[4],
                "prefix_hit_tokens": s1[5] - s0[5],
                "cached_blocks": pc.resident_blocks if pc else 0,
            })
        return worked

    # ------------------------------------------------------------------
    # State snapshot
    # ------------------------------------------------------------------

    def report_state(self) -> dict:
        """Snapshot occupancy + flight recorder (the reference also pushes
        it to the controller; the port has no controller yet)."""
        snap = self.recorder.snapshot()
        snap["steps"] = snap["steps"][-32:]
        snap["recent_requests"] = snap["recent_requests"][-64:]
        pc = self.prefix_cache
        snap.update(
            ts=time.time(),
            engine_id=self.engine_id,
            tags=dict(self.metrics_tags),
            stats=dict(self.stats),
            occupancy={
                "active": self.active_count(),
                "waiting": len(self.waiting),
                "kv_blocks_free": self.alloc.available,
                "kv_blocks_total": self.pcfg.usable_blocks,
                "max_batch": self.pcfg.max_batch,
            },
            prefix_cache={
                "enabled": pc is not None,
                "resident_blocks": pc.resident_blocks if pc else 0,
                "evictable_blocks": pc.evictable_blocks if pc else 0,
                "hit_tokens": self.stats["prefix_hit_tokens"],
                "lookup_tokens": self.stats["prefix_lookup_tokens"],
                "hit_rate": self.stats["prefix_hit_tokens"]
                / max(1, self.stats["prefix_lookup_tokens"]),
                "evictions": self.stats["prefix_evictions"],
            },
            overlap={
                "enabled": self.overlap,
                "windows": self.stats["steps"],
                "spec_windows": self.stats["spec_windows"],
                "occupancy": self.stats["spec_windows"] / max(1, self.stats["steps"]),
                "h2d_ships": self.stats["h2d_ships"],
                "h2d_skips": self.stats["h2d_skips"],
            },
        )
        return snap
