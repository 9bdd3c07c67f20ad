"""Continuous batching, on torch tensors: dense slots and a paged KV pool.

Counterpart of ``BatchEngine`` (with ``_Slot`` and ``_bucket``),
``PageAllocator``, ``PagedBatchEngine`` and ``make_stub_paged_engine`` of
dora_tpu/models/batch_engine.py.

``BatchEngine`` is the dense engine: every slot owns a [KV, max_seq, hd]
plane per layer; ``submit`` prefills a prompt (right-padded to a
power-of-two bucket) into a free slot and returns its first token at once;
``step`` advances every active slot one token with one batched fused pass,
so new requests join mid-flight. Idle slots ride along pinned at position
0.

Both engines carry the serving node's hooks (``tracer``, a
telemetry.ServingTracer, and ``serving_metrics``, a metrics.ServingMetrics;
None unless a server attaches them): request-lifecycle spans (admitted,
prefill chunk, decode window, preempt) and the fetch-latency and
page-grant histograms, where the JAX engines record them.

Both engines run their decode dispatch through models/vlm.GraphedWindow:
with ``graphs`` (None, the default, means on for a CUDA device; True on the
CPU raises) each window (one per (K, spec_k)) and the dense step is ONE
CUDA-graph replay over the engine's static buffers, which the engine
therefore updates in place and never rebinds; ``graph_captures`` counts the
captures, the counterpart of the reference's compile guard. With
``graphs=False`` (always on the CPU) the same runner runs the body eagerly
over the same buffers. The prefill (the paged chunk, the dense submit) is
eager either way.

The device plane (dora_tpu_torch/profiling.py) is the JAX paged engine's:
with ``DORA_DEVICE_MONITOR`` on (the default) each window's and each
chunk's wall time splits into host dispatch / device compute / fetch (a
CUDA event recorded after the dispatch and synchronized before the
device-to-host read), and the FLOPs ledger counts dispatched and useful
(emitted) work from the factories' ``flops_per_token``.

``PagedBatchEngine``: the same scheduling (one prefill chunk for
the stream at the head of the line, then one K-tick decode window per
:meth:`PagedBatchEngine.step`), the same page grants, the null page 0, the
block tables and the first token read from the final chunk at
``true_len - 1 - base``; prompt-lookup speculation inside the window with
its admission headroom and host history mirror; the shared-prefix cache
(models/prefix_cache.py) with its refcount custody; window retuning
(:meth:`PagedBatchEngine.set_window`); multi-tenant LoRA (a stream's
adapter pinned resident in models/lora_pool.AdapterPool for its life, its
slot id carried to every pass, the prefix cache keyed on (adapter,
tokens)); int8 KV pools (their scale planes ride in the pools dict);
preemption (:meth:`PagedBatchEngine.preempt`) with the victim's cached
prefix pinned while it waits (``prefix_pin`` / ``prefix_unpin``);
checkpoint, restore and migration (``checkpoint_state`` / ``restore_state``
/ ``drain_streams`` / ``admit_streams``, the same JSON as the JAX engine's,
and ``save_pools`` / ``restore_pools`` over models/checkpoint.py). A
restored stream's row of the static window buffers is rewritten before the
next window, as a preempted one's is.
"""

from __future__ import annotations

import time
from collections import Counter, deque
from dataclasses import dataclass

import numpy as np
import torch

from dora_tpu_torch import profiling
from dora_tpu_torch._device import resolve_device
from dora_tpu_torch.models import checkpoint
from dora_tpu_torch.models.prefix_cache import PrefixCache


@dataclass
class _Slot:
    request_id: str
    emitted: int
    max_new: int


class _DevicePlane:
    """The device-plane counters both engines keep (the JAX paged engine's
    attributes, dora_tpu/models/batch_engine.py), fed by their step path."""

    def _init_device_plane(self, device) -> None:
        #: device utilization plane (dora_tpu_torch.profiling): when the
        #: monitor is on, the step path splits each dispatch's wall time
        #: into host dispatch / device compute / device fetch and keeps an
        #: analytic FLOPs ledger
        self.device_monitor = profiling.monitor_enabled()
        self.host_dispatch_ns = 0
        self.device_compute_ns = 0
        self.device_fetch_ns = 0
        #: FLOPs dispatched (every active row x K x (spec_k+1)) vs useful
        #: (emitted tokens only): the gap is frozen rows plus speculation's
        #: rejected tails
        self.dispatched_flops = 0
        self.useful_flops = 0
        #: analytic per-token forward FLOPs (0 = model unknown: the ledger
        #: stays zero) and the device's peak FLOP/s for MFU's denominator;
        #: set by the engine factories
        self.flops_per_token = 0
        self.device_peak_flops = 0.0
        self._done = torch.cuda.Event() if device.type == "cuda" else None
        #: observability hooks the serving node attaches: ``tracer`` (a
        #: telemetry.ServingTracer) and ``serving_metrics`` (a
        #: metrics.ServingMetrics, for the fetch and grant histograms);
        #: None elsewhere, one attribute check per hook site
        self.tracer = None
        self.serving_metrics = None
        #: request_id -> seconds its first token waited host-side between
        #: its fetch and the engine call returning; the server subtracts it
        #: from the TTFT it measures (fed only while serving_metrics is on)
        self.emit_lag_s: dict[str, float] = {}

    def _fetch(self, t_dispatch: float | None, fetch, what: str = "window"):
        """``fetch()``, the blocking device-to-host read of what was
        dispatched since ``t_dispatch`` (None: dispatch time counted
        already), its wait observed in ``serving_metrics.fetch_latency``.
        With the monitor on, the wall time splits at an event recorded after
        the dispatch and synchronized (never the whole device; the CPU
        computed it already) into host dispatch, device compute and fetch,
        each also an ``s_dev_*`` span of ``what`` on an attached tracer."""
        t_fetch = time.perf_counter()
        if not self.device_monitor:
            out = fetch()
        else:
            if t_dispatch is not None:
                self.host_dispatch_ns += _ns(t_fetch - t_dispatch)
                self._dev_span("s_dev_dispatch", what, t_fetch - t_dispatch)
            if self._done is not None:
                self._done.record()
                self._done.synchronize()
            t_ready = time.perf_counter()
            self.device_compute_ns += _ns(t_ready - t_fetch)
            self._dev_span("s_dev_compute", what, t_ready - t_fetch)
            out = fetch()
            self.device_fetch_ns += _ns(time.perf_counter() - t_ready)
            self._dev_span("s_dev_fetch", what, time.perf_counter() - t_ready)
        if self.serving_metrics is not None:
            self.serving_metrics.fetch_latency.observe((time.perf_counter() - t_fetch) * 1e6)
        return out

    def _dev_span(self, kind: str, what: str, seconds: float) -> None:
        if self.tracer is not None:
            self.tracer.span(kind, what, dur_ns=_ns(seconds))


def _ns(seconds: float) -> int:
    return int(seconds * 1e9)


def _bucket(n: int, cap: int) -> int:
    """Smallest power of two >= n (min 8), capped at the cache length."""
    b = 8
    while b < n:
        b *= 2
    return min(b, cap)


class BatchEngine(_DevicePlane):
    """Dense continuous batching over the family's closures:
    ``init_caches(n)`` -> the [n, ...] cache tree; ``prefill(ids [1, TB],
    true_len)`` -> (first [1] int32, one-slot caches, position);
    ``batch_step(tokens [B], caches, positions [B])`` -> (greedy [B],
    caches) (models/hf/qwen2.make_batch_engine). A step is one call of the
    engine's runner (models/vlm.GraphedWindow, a CUDA graph with
    ``graphs``): ``batch_step``, then tokens and the live slots' positions
    advance in place."""

    def __init__(self, *, init_caches, prefill, batch_step, max_slots: int = 4,
                 max_seq: int, eos: int | None = None, device=None,
                 graphs: bool | None = None):
        from dora_tpu_torch.models.vlm import GraphedWindow, use_graphs

        self.device = resolve_device(device)
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.eos = eos
        self.prefill = prefill
        self.batch_step = batch_step
        self.caches = init_caches(max_slots)
        self.tokens = torch.zeros((max_slots,), dtype=torch.int32, device=self.device)
        self.positions = torch.zeros((max_slots,), dtype=torch.int32, device=self.device)
        self.slots: list[_Slot | None] = [None] * max_slots
        # Active-slot mask, rewritten in place only when slot membership
        # changes (the step's graph reads these buffers).
        self._mask = torch.zeros((max_slots,), dtype=torch.bool, device=self.device)
        self._imask = torch.zeros((max_slots,), dtype=torch.int32, device=self.device)
        self._members_dirty = True
        self.graphs = use_graphs(graphs, self.device)
        #: what a step calls (a caller may wrap it); ``_runner`` stays the
        #: runner itself
        self.runner = self._runner = GraphedWindow(self._step_body, carry=(0, 1, 2),
                                                   graph=self.graphs)
        self._init_device_plane(self.device)
        #: device passes launched / device-to-host token fetches (the paged
        #: engine's fields, so a server reads either engine alike)
        self.dispatches = 0
        self.fetches = 0

    # -- admission -----------------------------------------------------------

    @property
    def free_slots(self) -> int:
        return sum(s is None for s in self.slots)

    @property
    def active(self) -> int:
        return self.max_slots - self.free_slots

    def fits(self, prompt_len: int, max_new: int) -> bool:
        """Length admissibility alone (a request that never fits must be
        rejected up front, not parked in a backlog)."""
        return prompt_len + max_new <= self.max_seq

    def can_admit(self, prompt_len: int, max_new: int) -> bool:
        return self.free_slots > 0 and self.fits(prompt_len, max_new)

    def _insert(self, sub, first, pos: int, b: int) -> None:
        """Copy a prefilled one-slot cache tree, its first token and its
        position into slot b, in place."""
        for layer, entry in sub.items():
            for key, one in entry.items():
                self.caches[layer][key][b : b + 1].copy_(one)
        self.tokens[b : b + 1].copy_(first)
        self.positions[b] = pos

    def submit(self, request_id: str, prompt_ids, max_new: int) -> tuple[int, bool]:
        """Prefill ``prompt_ids`` into a free slot; returns ``(first_token,
        done)``: the first generated token is emitted by this call (the
        steps emit the rest), and ``done`` is True when the stream completed
        at it (max_new == 1, or the first token is EOS). Raises if no slot
        is free or the request does not fit."""
        ids = list(prompt_ids)
        if not self.can_admit(len(ids), max_new):
            raise RuntimeError(
                f"cannot admit: {self.free_slots} slots free, "
                f"{len(ids)}+{max_new} vs max_seq {self.max_seq}"
            )
        b = self.slots.index(None)
        tb = _bucket(len(ids), self.max_seq)
        t0 = time.perf_counter()
        padded = torch.tensor([ids + [0] * (tb - len(ids))], dtype=torch.int32,
                              device=self.device)
        first, caches_1, pos = self.prefill(padded, len(ids))
        self._insert(caches_1, first, pos, b)
        self.dispatches += 1
        token = self._fetch(t0, lambda: int(first[0]), "prefill")
        self.fetches += 1
        if self.tracer is not None:
            # One span for grant and synchronous prefill: the dense engine
            # has no chunked phase.
            self.tracer.span("s_admitted", request_id, f"slot={b} bucket={tb}",
                             dur_ns=_ns(time.perf_counter() - t0))
        if self.device_monitor:
            self.dispatched_flops += tb * self.flops_per_token
            self.useful_flops += len(ids) * self.flops_per_token
        done = (self.eos is not None and token == self.eos) or max_new <= 1
        if not done:
            self.slots[b] = _Slot(request_id, emitted=1, max_new=max_new)
        # Even an instantly done submit moved this slot's position off 0.
        self._members_dirty = True
        return token, done

    # -- the batched step ----------------------------------------------------

    @property
    def graph_captures(self) -> int:
        """Bindings of the step's runner: its one CUDA-graph capture with
        ``graphs`` (else its first step). Stays 1 after the first step."""
        return self._runner.captures

    def _step_body(self, tokens, caches, positions, imask):
        """The step the runner replays: every slot's next token, and the
        live slots' positions one further."""
        nxt, caches = self.batch_step(tokens, caches, positions)
        return nxt, nxt, caches, positions + imask

    def step(self) -> list[tuple[str, int, bool]]:
        """One batched fused pass: every active slot advances one token.
        Returns [(request_id, token, done)] for the active slots (empty when
        idle). Slots free as they finish; a submit between steps joins the
        next pass."""
        if self.active == 0:
            return []
        # Idle slots pin at position 0, so their row's write never walks
        # toward the end of their plane. The mask and the pin run only when
        # membership changed; in steady state active rows advance by a
        # masked increment.
        if self._members_dirty:
            self._mask.copy_(torch.tensor([s is not None for s in self.slots]))
            self._imask.copy_(self._mask)
            self.positions.mul_(self._imask)
            self._members_dirty = False
        t0 = time.perf_counter()
        nxt = self.runner(self.tokens, self.caches, self.positions, self._imask)[0]
        self.dispatches += 1
        # ONE device-to-host copy for all slots
        host = self._fetch(t0, lambda: nxt.cpu().numpy())
        self.fetches += 1
        step_ns = _ns(time.perf_counter() - t0)
        if self.device_monitor:
            self.dispatched_flops += self.active * self.flops_per_token
        emitted = []
        for b, slot in enumerate(self.slots):
            if slot is None:
                continue
            token = int(host[b])
            slot.emitted += 1
            done = slot.emitted >= slot.max_new or (self.eos is not None and token == self.eos)
            if self.tracer is not None:
                # The dense step is a 1-tick window: the paged span's kind.
                self.tracer.span("s_decode_window", slot.request_id,
                                 f"K=1 emitted=1 frozen_at={1 if done else None}",
                                 dur_ns=step_ns)
            emitted.append((slot.request_id, token, done))
            if done:
                self.slots[b] = None
                self._members_dirty = True
        if self.device_monitor:
            self.useful_flops += len(emitted) * self.flops_per_token
        return emitted


class PageAllocator:
    """Fixed-pool block allocator over page-size KV blocks, with per-page
    refcounts.

    Physical page 0 is RESERVED as the null page: a zeroed block-table
    entry points there, so masked rows of the batched kernels dump their
    harmless writes into it. Allocation is all-or-nothing (``alloc``
    returns None rather than a partial grant), so an admitted stream can
    never run out of pages mid-decode. :meth:`free` is the exclusive
    release and raises on a double free or on a page another holder still
    references; shared holders release with :meth:`unref`."""

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError(f"a page pool needs >= 2 pages, got {num_pages}")
        self.num_pages = num_pages
        self._free = list(range(num_pages - 1, 0, -1))
        #: page id -> refcount; only pages with refcount >= 1 appear
        self._ref: dict[int, int] = {}
        #: high-water mark of pages in use
        self.peak_in_use = 0

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        """Pages currently granted (null page excluded)."""
        return self.num_pages - 1 - len(self._free)

    def largest_contiguous_free(self) -> int:
        """Longest run of adjacent free page ids: the fragmentation gauge
        of the serving metrics (grants go through block tables, so it never
        blocks one). O(free); read at report cadence."""
        ids = sorted(self._free)
        best = run = 1 if ids else 0
        for prev, cur in zip(ids, ids[1:]):
            run = run + 1 if cur == prev + 1 else 1
            best = max(best, run)
        return best

    def alloc(self, n: int) -> list[int] | None:
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._ref[p] = 1
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        return pages

    def take(self, pages: list[int]) -> bool:
        """Claim these page ids (a checkpoint restore, whose block tables
        name physical pages). All-or-nothing like :meth:`alloc`; False on a
        repeated id or a page that is not free (the restore ref-shares
        those). The free list keeps its order, so later grants hand out the
        JAX allocator's ids."""
        free = set(self._free)
        if len(set(pages)) != len(pages) or not all(p in free for p in pages):
            return False
        claim = set(pages)
        self._free = [p for p in self._free if p not in claim]
        for p in pages:
            self._ref[p] = 1
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        return True

    def refcount(self, page: int) -> int:
        """Current holder count for one page (0 = free)."""
        return self._ref.get(page, 0)

    def ref(self, pages: list[int]) -> None:
        """Add one reference per page; raises on pages nobody holds."""
        for p in pages:
            rc = self._ref.get(p, 0)
            if rc <= 0:
                raise RuntimeError(f"cannot ref page {p}: not allocated (refcount 0)")
            self._ref[p] = rc + 1

    def unref(self, pages: list[int]) -> None:
        """Drop one reference per page; a page returns to the free list when
        its last reference drops. Raises on a double free."""
        for p in pages:
            rc = self._ref.get(p, 0)
            if rc <= 0:
                raise RuntimeError(f"double free: page {p} is not allocated")
            if rc == 1:
                del self._ref[p]
                self._free.append(p)
            else:
                self._ref[p] = rc - 1

    def free(self, pages: list[int]) -> None:
        """Exclusive release: raises on a double free and on a shared page."""
        for p in pages:
            rc = self._ref.get(p, 0)
            if rc <= 0:
                raise RuntimeError(f"double free: page {p} is not allocated")
            if rc > 1:
                raise RuntimeError(
                    f"free of shared page {p} (refcount {rc}); "
                    f"shared holders release via unref"
                )
        self.unref(pages)

    def check_invariants(self) -> None:
        """Every page is exactly one of {null, free, refcounted}."""
        free = self._free
        assert len(set(free)) == len(free), "duplicate pages in free list"
        assert all(0 < p < self.num_pages for p in free), \
            "free list holds out-of-range or null page ids"
        assert all(rc >= 1 for rc in self._ref.values()), \
            "zero/negative refcount retained"
        assert all(0 < p < self.num_pages for p in self._ref), \
            "refcounted out-of-range or null page"
        assert set(free).isdisjoint(self._ref), "page both free and refcounted"
        assert len(free) + len(self._ref) == self.num_pages - 1, (
            f"page accounting broken: {len(free)} free + "
            f"{len(self._ref)} in use != {self.num_pages - 1}"
        )


@dataclass
class _PagedSlot:
    request_id: str
    emitted: int
    max_new: int
    pages: list[int]
    prompt: list[int] | None  # pending prompt ids; None once decoding
    true_len: int
    chunk_base: int = 0
    #: leading pages mapped from the prefix cache (refcount-shared)
    shared: int = 0
    #: LoRA tenant name (None = base model) and its resident slot, pinned
    #: for the stream's life so the device adapter vector cannot go stale
    adapter: str | None = None
    adapter_idx: int = 0


class PagedBatchEngine(_DevicePlane):
    """Continuous batching over a paged KV pool with chunked prefill.

    KV lives in a fixed pool of page-size blocks; each slot holds a block
    table (``[max_pages]`` int32 of physical page ids) and pages are
    granted at admission for the context the stream can reach
    (``max(chunk-padded prompt, prompt + max_new)`` rows).

    :meth:`step` runs ONE prefill chunk of the head-of-line prefilling
    stream, then ONE K-tick decode window for every decoding stream, and
    copies one ``[B, K+1]`` token matrix to the host. Completion is
    detected on the device and a finished row freezes mid-window; the host
    unpacks each row up to its done offset.

    Closures (see models/hf/qwen2.make_paged_engine):
      * ``init_pool(num_pages)`` -> pools
      * ``chunk_prefill(ids [C], pools, position: int, bt_row [P])`` ->
        (greedy [C], pools)
      * ``window_step(tokens, pools, positions, bts, active, emitted,
        max_new)`` -> (mat [B, K+1], tokens, positions, active, emitted,
        pools)
      * ``window_factory(k, spec_k)`` -> a window step, for
        :meth:`set_window` (None pins the window for life)

    With a ``lora_pool`` (models/lora_pool.AdapterPool) ``chunk_prefill``
    also takes the stream's adapter slot and the resident stack, and the
    window the per-slot adapter vector [B] and the stack, as trailing
    operands.

    With ``spec_k > 0`` (models/vlm.make_paged_spec_window) the window also
    takes and returns each stream's token history [B, max_seq + spec_k + 1]
    and its length [B], and ``mat`` is the ragged [B, K*(spec_k+1) + 1]
    emission matrix. Tokens are identical to ``spec_k = 0``. With
    ``prefix_cache`` a new stream maps the cached pages of its longest
    cached prompt prefix and its prefill starts there.

    Every window runs through a models/vlm.GraphedWindow runner (one per
    (K, spec_k), cached), which ``graphs`` makes one CUDA-graph replay; its
    carried operands are this engine's buffers, updated in place.
    """

    def __init__(self, *, init_pool, chunk_prefill, window_step,
                 max_slots: int = 16, max_seq: int, page_size: int,
                 chunk: int, num_pages: int, eos: int | None = None,
                 window: int = 8, spec_k: int = 0, spec_ngram: int = 2,
                 window_factory=None, prefix_cache: bool = False,
                 prefix_cache_pages: int = 0, lora_pool=None, device=None,
                 graphs: bool | None = None):
        from dora_tpu_torch.models.vlm import use_graphs

        if (page_size % 8 or chunk % page_size or max_seq % chunk or window < 1
                or spec_k < 0):
            raise ValueError(
                f"page {page_size} (multiple of 8), chunk {chunk} (multiple "
                f"of page), max_seq {max_seq} (multiple of chunk), window "
                f"{window} (>= 1), spec_k {spec_k} (>= 0)"
            )
        dev = resolve_device(device)
        self.device = dev
        self.graphs = use_graphs(graphs, dev)
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.page_size = page_size
        self.chunk = chunk
        self.eos = eos
        self.chunk_prefill = chunk_prefill
        self.window_step = self._wrap(window_step, spec_k)
        self.window = window
        self.max_pages = max_seq // page_size
        self.pools = init_pool(num_pages)
        first = self.pools.get("0") if isinstance(self.pools, dict) else None
        #: "int8" when the pools carry scale planes, else "fp"
        self.kv_dtype = "int8" if isinstance(first, dict) and "ks" in first else "fp"
        self.allocator = PageAllocator(num_pages)
        self.prefix_cache = (
            PrefixCache(self.allocator, page_size, max_pages=prefix_cache_pages)
            if prefix_cache else None
        )
        #: live speculation width (0 = the plain window); set_window can
        #: pause it and resume the configured width _spec_cfg, which the
        #: history mirror and the admission headroom follow, so pages stay
        #: reserved for the verify tail while paused
        self.spec_k = spec_k
        self._spec_cfg = spec_k
        self.spec_ngram = spec_ngram
        self._window_factory = window_factory
        self._window_cache = {(window, spec_k): self.window_step}
        if spec_k:
            # Host mirror of each stream's prompt + emissions; the device
            # copy is rewritten from it only when membership changes.
            self._hist_buf = max_seq + spec_k + 1
            self._hist: list[list[int]] = [[] for _ in range(max_slots)]
            self._hist_dev = torch.zeros((max_slots, self._hist_buf), dtype=torch.int32, device=dev)
            self._histlen_dev = torch.zeros((max_slots,), dtype=torch.int32, device=dev)
        # Host block tables (the scheduler's source of truth) plus a device
        # DECODE view with non-decoding rows zeroed: a slot mid-prefill holds
        # real pages, and its masked decode row (pinned at position 0) must
        # write to the null page instead of clobbering prefilled context.
        self._bt = np.zeros((max_slots, self.max_pages), np.int32)
        self._bt_dec = torch.zeros((max_slots, self.max_pages), dtype=torch.int32, device=dev)
        self._bt_dirty = False
        self.tokens = torch.zeros((max_slots,), dtype=torch.int32, device=dev)
        self.positions = torch.zeros((max_slots,), dtype=torch.int32, device=dev)
        self.slots: list[_PagedSlot | None] = [None] * max_slots
        self._decode = [False] * max_slots
        self._prefillq: deque[int] = deque()
        self._mask = torch.zeros((max_slots,), dtype=torch.bool, device=dev)
        # Per-slot device vectors carried through the window, rewritten in
        # place from the host slots only when membership changes (the
        # window's graph reads these very buffers).
        self._emitted_dev = torch.zeros((max_slots,), dtype=torch.int32, device=dev)
        self._maxnew_dev = torch.zeros((max_slots,), dtype=torch.int32, device=dev)
        #: multi-tenant LoRA: the resident-adapter pool and the per-slot
        #: adapter slot vector handed to every window (None = no adapters)
        self.lora = lora_pool
        self._adapter_dev = torch.zeros((max_slots,), dtype=torch.int32, device=dev)
        self._members_dirty = True
        #: prefill chunks run
        self.chunks_run = 0
        #: host->device program dispatches / device->host token copies
        self.dispatches = 0
        self.fetches = 0
        self._init_device_plane(dev)

    # -- admission -----------------------------------------------------------

    @property
    def free_slots(self) -> int:
        return sum(s is None for s in self.slots)

    @property
    def active(self) -> int:
        return self.max_slots - self.free_slots

    @property
    def prefilling(self) -> int:
        return len(self._prefillq)

    @property
    def free_pages(self) -> int:
        return self.allocator.free_pages

    def spec_headroom(self) -> int:
        """Rows a verification pass may write past ``prompt + max_new``:
        the last verify starts at ``prompt + max_new - 1`` and writes
        spec_k + 1 rows. 0 with speculation off. It follows the CONFIGURED
        width, so a stream admitted while speculation is paused still owns
        its verify tail when it resumes."""
        return self._spec_cfg + 1 if self._spec_cfg else 0

    def fits(self, prompt_len: int, max_new: int,
             adapter: str | None = None) -> bool:
        """Admissible EVER: the length (with the spec headroom) fits the
        block table, the whole pool could grant its pages, and a named
        adapter is one this engine can make resident."""
        if adapter and (self.lora is None or not self.lora.has(adapter)):
            return False
        return (
            prompt_len + max_new + self.spec_headroom() <= self.max_seq
            and self.pages_needed(prompt_len, max_new) <= self.allocator.num_pages - 1
        )

    def pages_needed(self, prompt_len: int, max_new: int, cached: int = 0) -> int:
        """Pages a stream can touch end to end: the chunk-padded prefill
        writes (whole pages) or prompt + max_new decode rows plus the spec
        verify tail, whichever reaches further. With ``cached`` prompt
        tokens mapped from the prefix cache, prefill starts there (a page
        multiple); the count still includes the shared pages."""
        chunk_rows = cached + -(-(prompt_len - cached) // self.chunk) * self.chunk
        rows = max(chunk_rows, prompt_len + max_new + self.spec_headroom())
        return -(-rows // self.page_size)

    def can_admit(self, prompt_len: int, max_new: int,
                  adapter: str | None = None) -> bool:
        avail = self.free_pages
        if self.prefix_cache is not None:
            # Unpinned, unshared cached pages are free-in-waiting.
            avail += self.prefix_cache.evictable_pages()
        if adapter and (self.lora is None or not self.lora.fits(adapter)):
            # Adapter residency is admission state like pages: with every
            # resident slot pinned by live streams the tenant waits.
            return False
        return (
            self.free_slots > 0
            and self.fits(prompt_len, max_new, adapter)
            and self.pages_needed(prompt_len, max_new) <= avail
        )

    def admit_blocker(self, prompt_len: int, max_new: int,
                      adapter: str | None = None) -> str | None:
        """Why :meth:`can_admit` says no: ``"adapter_residency"`` where all
        else admits but the tenant's adapter cannot evict a pinned resident,
        ``"capacity"`` for slots, pages or length, None when admissible."""
        if self.can_admit(prompt_len, max_new, adapter):
            return None
        if (adapter and self.lora is not None and self.lora.has(adapter)
                and not self.lora.fits(adapter)
                and self.can_admit(prompt_len, max_new, None)):
            return "adapter_residency"
        return "capacity"

    def submit(self, request_id: str, prompt_ids, max_new: int,
               adapter: str | None = None) -> None:
        """Admit a stream: pin its adapter resident (``adapter`` names the
        LoRA tenant, None the base model), map its cached prefix pages (if
        any), grant the rest fresh (evicting cached pages when the pool is
        short), write its block table and queue its prefill. The first token
        comes from a later :meth:`step`."""
        ids = [int(t) for t in prompt_ids]
        if not ids:
            raise ValueError("empty prompt")
        if not self.can_admit(len(ids), max_new, adapter):
            raise RuntimeError(
                f"cannot admit: {self.free_slots} slots, {self.free_pages} "
                f"pages free vs {self.pages_needed(len(ids), max_new)} needed "
                f"({len(ids)}+{max_new}, max_seq {self.max_seq}"
                + (f", adapter {adapter!r}" if adapter else "") + ")"
            )
        aidx = 0
        if adapter:
            aidx = self.lora.acquire(adapter)
            if aidx is None:
                raise RuntimeError(
                    f"cannot admit {request_id!r}: adapter pool full of pinned "
                    f"adapters ({adapter!r} not resident)"
                )
        b = self.slots.index(None)
        base0, shared = 0, []
        if self.prefix_cache is not None:
            base0, shared = self._prefix_grant(ids, max_new, adapter)
        need = self.pages_needed(len(ids), max_new, base0) - len(shared)
        if need > self.allocator.free_pages and self.prefix_cache is not None:
            self.prefix_cache.evict(need - self.allocator.free_pages)
        fresh = self.allocator.alloc(need)
        if fresh is None:
            if shared:
                self.allocator.unref(shared)
            if adapter:
                self.lora.release(adapter)
            raise RuntimeError(
                f"cannot admit {request_id!r}: page pool exhausted "
                f"({need} fresh needed, {self.free_pages} free)"
            )
        pages = shared + fresh
        self._bt[b, :] = 0
        self._bt[b, : len(pages)] = pages
        self.slots[b] = _PagedSlot(
            request_id, emitted=0, max_new=max_new, pages=pages, prompt=ids,
            true_len=len(ids), chunk_base=base0, shared=len(shared),
            adapter=adapter, adapter_idx=aidx,
        )
        self._decode[b] = False
        self._prefillq.append(b)
        self._bt_dirty = True
        if self._spec_cfg:
            self._hist[b] = list(ids)  # drafts look up the prompt too
        if self.serving_metrics is not None:
            g = self.serving_metrics.grant_pages
            g[len(pages)] = g.get(len(pages), 0) + 1
        if self.tracer is not None:
            if base0:
                self.tracer.span("s_prefix_hit", request_id,
                                 f"tokens={base0}/{len(ids)} pages={len(shared)}")
            self.tracer.span("s_admitted", request_id, f"slot={b} pages={len(pages)}"
                             + (f" shared={len(shared)}" if shared else ""))

    def _prefix_grant(self, ids: list[int], max_new: int,
                      adapter: str | None = None) -> tuple[int, list[int]]:
        """The longest usable cached prefix of a new prompt, trimmed so that
        (a) the final prompt token is prefilled again (the first token comes
        off that chunk), (b) the chunk-padded prefill stays inside the block
        table, and (c) the fresh pages still fit free + evictable pages.
        Refs the shared pages into this stream's custody and returns
        ``(divergence base, shared page ids)``. A trimmed boundary page is
        prefilled again privately by the divergence chunk (the
        copy-on-write boundary), never written in place. The lookup walks the
        stream's own adapter tree: tenants never map each other's KV."""
        ps = self.page_size
        cache = self.prefix_cache
        matched, pages, mid_page = cache.lookup(ids, adapter)
        cap = (len(ids) - 1) // ps * ps
        lo = min(matched, cap)
        while lo and lo + -(-(len(ids) - lo) // self.chunk) * self.chunk > self.max_seq:
            lo -= ps
        shared = pages[: lo // ps]
        if shared:
            self.allocator.ref(shared)
        # The chunk overhang past a divergence that is not chunk-aligned can
        # cost a page more than the no-cache grant: back off page by page
        # until the grant can_admit promised still fits.
        while shared:
            need = self.pages_needed(len(ids), max_new, lo) - len(shared)
            if need <= self.allocator.free_pages + cache.evictable_pages():
                break
            self.allocator.unref([shared.pop()])
            lo -= ps
        if not shared:
            lo = 0
        if lo:
            cache.hits += 1
            cache.hit_tokens += lo
        else:
            cache.misses += 1
        if matched > lo or mid_page:
            cache.cow_copies += 1
        return lo, shared

    def _free_slot(self, b: int) -> None:
        # unref, not free: leading pages may be shared with the prefix cache
        # and other streams; a page returns when its last holder lets go.
        self.allocator.unref(self.slots[b].pages)
        if self.lora is not None and self.slots[b].adapter:
            # Drop the stream's residency pin; the adapter stays warm.
            self.lora.release(self.slots[b].adapter)
        self._bt[b, :] = 0
        self.slots[b] = None
        self._decode[b] = False
        self._bt_dirty = True
        self._members_dirty = True
        if self._spec_cfg:
            self._hist[b] = []

    @property
    def shared_pages(self) -> int:
        """Pages mapped shared into live streams' block tables (the cache's
        own holdings are ``prefix_cache.size``)."""
        return sum(s.shared for s in self.slots if s is not None)

    def prefix_pin(self, ids, adapter: str | None = None) -> int:
        """Pin the cached path of ``ids`` against eviction: a preempted
        victim's prefix waits for its resume on refcount custody, not slot
        custody. No-op without a cache."""
        if self.prefix_cache is None:
            return 0
        return self.prefix_cache.pin(ids, adapter)

    def prefix_unpin(self, ids, adapter: str | None = None) -> None:
        if self.prefix_cache is not None:
            self.prefix_cache.unpin(ids, adapter)

    def preempt(self, request_id: str) -> dict | None:
        """Evict a live stream: its slot and its whole page grant are freed
        (the grant is all-or-nothing, so the footprint is exact). Call
        between steps, where host slots and device vectors agree: the freed
        row's block table is zeroed and the window's membership is rebuilt
        in its static buffers before the next window, so stale writes go to
        the null page.

        Returns ``{"emitted", "max_new", "pages", "was_decoding", "adapter"}``
        for the caller's resume, or None if the id is not live. The engine
        keeps no emitted tokens: the server re-submits prompt + emitted
        with the remaining budget."""
        b = next((i for i, s in enumerate(self.slots)
                  if s is not None and s.request_id == request_id), None)
        if b is None:
            return None
        s = self.slots[b]
        if s.prompt is not None and b in self._prefillq:
            self._prefillq.remove(b)  # still prefilling
        meta = {"emitted": s.emitted, "max_new": s.max_new, "pages": len(s.pages),
                "was_decoding": bool(self._decode[b]), "adapter": s.adapter}
        self._free_slot(b)
        if self.serving_metrics is not None:
            self.serving_metrics.preempted += 1
        if self.tracer is not None:
            self.tracer.span("s_preempt", request_id,
                             f"slot={b} pages={meta['pages']} emitted={meta['emitted']}")
        return meta

    # -- checkpoint / restore / migration ------------------------------------

    def checkpoint_state(self) -> dict:
        """JSON-able snapshot of every live stream (the JAX engine's format):
        slot metadata, page grants, each slot's last token and position.
        Call between steps: at a window boundary the carried ``tokens`` /
        ``positions`` buffers agree with the host slots. Pool contents are
        not included (:meth:`save_pools`)."""
        toks = self.tokens.cpu().tolist()
        pos = self.positions.cpu().tolist()
        slots = []
        for b, s in enumerate(self.slots):
            if s is None:
                continue
            meta = {
                "slot": b,
                "request_id": s.request_id,
                "emitted": s.emitted,
                "max_new": s.max_new,
                "pages": [int(p) for p in s.pages],
                "shared": s.shared,
                "prompt": list(s.prompt) if s.prompt is not None else None,
                "true_len": s.true_len,
                "chunk_base": s.chunk_base,
                "decode": bool(self._decode[b]),
                "last_token": int(toks[b]),
                "position": int(pos[b]),
            }
            if s.adapter:
                # The tenant's name, never its resident slot (slots are
                # recycled and mean nothing to another engine).
                meta["adapter"] = s.adapter
            if self._spec_cfg:
                # The draft-lookup history: tokens are exact without it, but
                # with it a resume keeps the acceptance (and dispatches).
                meta["history"] = [int(t) for t in self._hist[b]]
            slots.append(meta)
        return {"slots": slots, "kv_dtype": self.kv_dtype}

    def restore_state(self, state: dict, *, pin_slots: bool = True) -> list[str]:
        """Rebuild the live streams of :meth:`checkpoint_state`; returns the
        restored request ids.

        Decoding streams resume from ``(last_token, position)``: with
        ``pin_slots`` on their exact slot and page ids (needed when the
        pools were restored, since the block tables name physical pages; a
        page several slots share is taken by the first and ref-shared by
        the later ones), else on fresh slots and pages (migrate-in, which
        ships no pools). Mid-prefill streams re-submit from scratch, which
        is token-exact (they emitted nothing). A snapshot whose
        ``kv_dtype`` (absent: "fp") is not this engine's raises. Each
        restored row of the static window buffers is rewritten before the
        next window (``tokens`` / ``positions`` here, the block table, mask,
        counts, adapter vector and history through the dirty flags)."""
        snap_dtype = state.get("kv_dtype", "fp")
        if snap_dtype != self.kv_dtype:
            raise ValueError(
                f"checkpoint kv_dtype {snap_dtype!r} does not match engine "
                f"kv_dtype {self.kv_dtype!r}: re-serve the snapshot on an "
                f"engine built with the same DORA_KV_INT8 setting"
            )
        restored: list[str] = []
        #: pages an earlier slot of this restore already claimed
        claimed: set[int] = set()
        # Decoding slots first: with pin_slots their index is fixed, and a
        # prefill re-submit must not take it.
        for meta in sorted(state.get("slots", []), key=lambda m: not m.get("decode")):
            if not meta.get("decode"):
                self.submit(meta["request_id"], meta["prompt"], meta["max_new"],
                            adapter=meta.get("adapter"))
                restored.append(meta["request_id"])
                continue
            # Re-pin the tenant resident before the slot exists, so the first
            # window gathers its adapter.
            adapter = meta.get("adapter")
            if adapter and self.lora is None:
                raise RuntimeError(
                    f"cannot restore stream {meta['request_id']!r}: snapshot names "
                    f"adapter {adapter!r} but this engine has no adapter pool"
                )
            aidx = self.lora.acquire(adapter) if self.lora is not None else 0
            if aidx is None:
                raise RuntimeError(
                    f"cannot restore stream {meta['request_id']!r}: adapter "
                    f"{adapter!r} cannot be made resident"
                )
            n_pages = len(meta["pages"])
            if pin_slots:
                b = meta["slot"]
                pages = [int(p) for p in meta["pages"]]
                fresh = [p for p in pages if p not in claimed]
                if self.slots[b] is not None or not self.allocator.take(fresh):
                    raise RuntimeError(
                        f"cannot restore stream {meta['request_id']!r}: slot {b} "
                        f"or its pages are busy"
                    )
                reshared = [p for p in pages if p in claimed]
                if reshared:
                    self.allocator.ref(reshared)
                claimed.update(pages)
            else:
                if self.free_slots == 0:
                    raise RuntimeError(
                        f"no free slot for migrated stream {meta['request_id']!r}")
                pages = self.allocator.alloc(n_pages)
                if pages is None:
                    raise RuntimeError(
                        f"no pages for migrated stream {meta['request_id']!r}")
                b = self.slots.index(None)
            self._bt[b, :] = 0
            self._bt[b, :n_pages] = pages
            self.slots[b] = _PagedSlot(
                meta["request_id"], emitted=meta["emitted"], max_new=meta["max_new"],
                pages=pages, prompt=None, true_len=meta["true_len"],
                chunk_base=meta["chunk_base"],
                # Fresh pages on a migrate-in: sharing does not survive it.
                shared=meta.get("shared", 0) if pin_slots else 0,
                adapter=adapter, adapter_idx=aidx,
            )
            self._decode[b] = True
            if self._spec_cfg:
                # A spec-off snapshot carries no history: the last token (the
                # lookup's fallback draft) keeps the resume exact, with cold
                # acceptance.
                self._hist[b] = [int(t) for t in meta.get("history") or [meta["last_token"]]]
            self.tokens[b] = int(meta["last_token"])
            self.positions[b] = int(meta["position"])
            self._bt_dirty = True
            self._members_dirty = True
            restored.append(meta["request_id"])
        return restored

    def drain_streams(self) -> dict:
        """Snapshot every live stream and free its slot and pages: the
        migrate-out half of a live migration (call between steps; the
        target takes the result in :meth:`admit_streams`)."""
        state = self.checkpoint_state()
        for b, s in enumerate(self.slots):
            if s is not None:
                self._free_slot(b)
        self._prefillq.clear()
        return state

    def admit_streams(self, state: dict) -> list[str]:
        """Admit streams drained from another engine (migrate-in) on fresh
        slots and pages. No KV pages travel, so a decoding stream continues
        exactly only where the step reads (token, position) alone."""
        return self.restore_state(state, pin_slots=False)

    def save_pools(self, path) -> None:
        """Persist the KV pools (models/checkpoint.py), for engines whose
        decode reads them."""
        checkpoint.save(path, self.pools)

    def restore_pools(self, path) -> None:
        """Load saved KV pools into ``self.pools`` in place (the graphs hold
        their addresses: the pools are never rebound)."""
        checkpoint.restore(path, self.pools)

    def kv_pool_bytes(self) -> int:
        """Device bytes of the KV pools, scale planes included."""
        return sum(t.numel() * t.element_size()
                   for lp in self.pools.values() for t in lp.values())

    def kv_quant_error(self, sample_pages: int = 64) -> float | None:
        """The int8 pools' quantization-error gauge: the mean relative
        quantization step ``scale / (2 * rms(dequantized row) + eps)`` over up
        to ``sample_pages`` allocated pages of layer 0 (the worst-case
        rounding error as a share of the row's RMS). None on fp pools."""
        if self.kv_dtype != "int8":
            return None
        held = sorted(p for p in self.allocator._ref if p)[:sample_pages]
        if not held:
            return 0.0
        idx = torch.tensor(held, device=self.device)
        lp = self.pools[next(iter(self.pools))]
        errs = []
        for name, sname in (("k", "ks"), ("v", "vs")):
            q = lp[name][idx].float().cpu().numpy()    # [n, KV, page, hd]
            sc = lp[sname][idx].float().cpu().numpy()  # [n, KV, page]
            deq = q * sc[..., None]
            rms = np.sqrt(np.mean(deq * deq, axis=-1))
            errs.append(np.mean(sc / (2.0 * rms + 1e-8)))
        return float(np.mean(errs))

    def check_invariants(self) -> None:
        """Allocator bookkeeping plus cross-custody: every allocated page's
        refcount equals the number of holders that can name it (live slots'
        grants and prefix-cache nodes), and nothing else holds pages."""
        self.allocator.check_invariants()
        held: Counter = Counter()
        for s in self.slots:
            if s is not None:
                held.update(s.pages)
        if self.prefix_cache is not None:
            held.update(self.prefix_cache.pages())
        for p, n in held.items():
            rc = self.allocator.refcount(p)
            assert rc == n, f"page {p}: refcount {rc} != {n} holders"
        assert self.allocator.in_use == len(held), (
            f"{self.allocator.in_use} pages in use but only {len(held)} held "
            f"by slots and the cache"
        )

    def _wrap(self, window, spec_k: int):
        """A window of the factory in its runner (None stays None)."""
        from dora_tpu_torch.models.vlm import SPEC_WINDOW_CARRY, WINDOW_CARRY, GraphedWindow

        if window is None:
            return None
        return GraphedWindow(window, carry=SPEC_WINDOW_CARRY if spec_k else WINDOW_CARRY,
                             graph=self.graphs)

    @property
    def graph_captures(self) -> int:
        """Windows bound to this engine's buffers: one CUDA-graph capture
        per (K, spec_k) runner with ``graphs`` (else each runner's first
        call). Steady-state serving adds none: the counterpart of the
        reference's one-compile-per-window guard."""
        return sum(w.captures for w in self._window_cache.values() if w is not None)

    def set_window(self, k: int, *, spec_on: bool | None = None) -> bool:
        """Re-select the window K and pause or resume speculation at a
        window boundary (``spec_on`` None keeps the live setting). Windows
        come from ``window_factory`` and are cached per (k, spec_k). Safe
        mid-stream: the carried state is per-stream vectors, rebuilt on the
        next step, and tokens are the same at every setting. Returns True
        when the window changed."""
        if k < 1:
            raise ValueError(f"window K must be >= 1, got {k}")
        if self._window_factory is None:
            return False
        if spec_on is None:
            want_spec = self.spec_k
        else:
            want_spec = self._spec_cfg if spec_on else 0
        if k == self.window and want_spec == self.spec_k:
            return False
        key = (k, want_spec)
        fn = self._window_cache.get(key)
        if fn is None:
            fn = self._wrap(self._window_factory(k, want_spec), want_spec)
            self._window_cache[key] = fn
        self.window_step = fn
        self.window = k
        self.spec_k = want_spec
        self._members_dirty = True
        return True

    # -- the interleaved step ------------------------------------------------

    def step(self) -> list[tuple[str, int, bool]]:
        """One scheduler tick: one prefill chunk for the head-of-line
        prefilling stream, then one K-tick decode window for every decoding
        stream. Returns [(request_id, token, done)] in stream order."""
        dev = self.device
        emitted: list[tuple[str, int, bool]] = []
        #: (request_id, fetch time) of a first token emitted this step: its
        #: wait until step() returns is the TTFT lag
        first_emit: tuple[str, float] | None = None

        if self._prefillq:
            t_chunk = time.perf_counter()
            b = self._prefillq[0]
            s = self.slots[b]
            base = s.chunk_base
            piece = s.prompt[base : base + self.chunk]
            piece = piece + [0] * (self.chunk - len(piece))
            extra = (s.adapter_idx, self.lora.state()) if self.lora is not None else ()
            greedy, self.pools = self.chunk_prefill(
                torch.tensor(piece, dtype=torch.int32, device=dev), self.pools,
                base, torch.from_numpy(self._bt[b].copy()).to(dev), *extra,
            )
            t_disp = time.perf_counter()
            s.chunk_base = base + self.chunk
            self.chunks_run += 1
            self.dispatches += 1
            if self.device_monitor:
                self.host_dispatch_ns += _ns(t_disp - t_chunk)
                self._dev_span("s_dev_dispatch", "chunk", t_disp - t_chunk)
                self.dispatched_flops += self.chunk * self.flops_per_token
                self.useful_flops += min(self.chunk, s.true_len - base) * self.flops_per_token
            final_chunk = s.chunk_base >= s.true_len
            if final_chunk:  # the stream starts
                self._prefillq.popleft()
                if self.prefix_cache is not None:
                    # The prompt's full pages never change again (decode
                    # writes from true_len on): adopt them into the cache.
                    n_full = s.true_len // self.page_size
                    if n_full:
                        self.prefix_cache.insert(
                            s.prompt[: n_full * self.page_size], s.pages[:n_full],
                            s.adapter)
                s.prompt = None
                # Non-final chunks stay async (their device time shows in
                # the next wait); the final one waits for its first token.
                token = self._fetch(None, lambda: int(greedy[s.true_len - 1 - base].item()),
                                    "chunk")
                self.fetches += 1
                if self.serving_metrics is not None:
                    first_emit = (s.request_id, time.perf_counter())
                s.emitted = 1
                done = (self.eos is not None and token == self.eos) or s.max_new <= 1
                emitted.append((s.request_id, token, done))
                if done:
                    self._free_slot(b)
                else:
                    self._decode[b] = True
                    if self._spec_cfg:
                        self._hist[b].append(token)
                    self.tokens[b] = token
                    self.positions[b] = s.true_len
                    self._members_dirty = True
                    self._bt_dirty = True
            if self.tracer is not None:
                # A non-final chunk's span is its dispatch alone; the final
                # one's includes the blocking first-token fetch.
                self.tracer.span("s_prefill_chunk", s.request_id,
                                 f"base={base} chunk={self.chunk}"
                                 + (" final" if final_chunk else ""),
                                 dur_ns=_ns(time.perf_counter() - t_chunk))

        if any(self._decode):
            if self._members_dirty:
                live = [s is not None and self._decode[i] for i, s in enumerate(self.slots)]
                self._mask.copy_(torch.tensor(self._decode))
                self._emitted_dev.copy_(torch.tensor(
                    [s.emitted if ok else 0 for s, ok in zip(self.slots, live)],
                    dtype=torch.int32))
                self._maxnew_dev.copy_(torch.tensor(
                    [s.max_new if ok else 0 for s, ok in zip(self.slots, live)],
                    dtype=torch.int32))
                if self.lora is not None:
                    # A stream's slot is pinned for its life: the vector
                    # changes only with membership.
                    self._adapter_dev.copy_(torch.tensor(
                        [s.adapter_idx if ok else 0 for s, ok in zip(self.slots, live)],
                        dtype=torch.int32))
                if self.spec_k:
                    # The history follows membership too: between
                    # boundaries the window carries it and the host mirror
                    # appends the same tokens the unpack emits.
                    hist = np.zeros((self.max_slots, self._hist_buf), np.int32)
                    hlen = np.zeros((self.max_slots,), np.int32)
                    for i, ok in enumerate(live):
                        if ok:
                            row = self._hist[i][: self._hist_buf]
                            hist[i, : len(row)] = row
                            hlen[i] = len(row)
                    self._hist_dev.copy_(torch.from_numpy(hist))
                    self._histlen_dev.copy_(torch.from_numpy(hlen))
                self._members_dirty = False
            if self._bt_dirty:
                dec = self._bt * np.asarray(self._decode, np.int32)[:, None]
                self._bt_dec.copy_(torch.from_numpy(dec))
                self._bt_dirty = False
            args = (self.tokens, self.pools, self.positions, self._bt_dec,
                    self._mask, self._emitted_dev, self._maxnew_dev)
            if self.spec_k:
                args += (self._hist_dev, self._histlen_dev)
            if self.lora is not None:
                args += (self._adapter_dev, self.lora.state())
            t_win = time.perf_counter()
            # The runner carries tokens, positions, the mask, the counts and
            # the history forward in these buffers; only mat is new.
            mat = self.window_step(*args)[0]
            self.dispatches += 1
            # ONE device->host copy per window, before any other replay can
            # overwrite mat
            host = self._fetch(t_win, lambda: mat.cpu().numpy())
            self.fetches += 1
            t_done = time.perf_counter()
            if self.device_monitor:
                self.dispatched_flops += profiling.window_flops(
                    flops_per_token=self.flops_per_token, active=sum(self._decode),
                    k=self.window, spec_k=self.spec_k)
            if self.tracer is not None:
                self._window_spans(host, _ns(t_done - t_win))
            n_before = len(emitted)
            self._unpack(host, emitted)
            if self.device_monitor:
                # useful work = the tokens this window emitted
                self.useful_flops += (len(emitted) - n_before) * self.flops_per_token
        if first_emit is not None:
            key, t_first = first_emit
            self.emit_lag_s[key] = time.perf_counter() - t_first
        return emitted

    def _window_spans(self, host, win_ns: int) -> None:
        """One ``s_decode_window`` span per decoding stream, before the
        unpack frees finished slots; every row shares the window's time."""
        from dora_tpu_torch.models.vlm import spec_window_row_stats, window_row_stats

        for b, slot in enumerate(self.slots):
            if slot is None or not self._decode[b]:
                continue
            if self.spec_k:
                n_emit, frozen = spec_window_row_stats(host[b], self.window, self.spec_k + 1)
            else:
                n_emit, frozen = window_row_stats(host[b], self.window)
            self.tracer.span("s_decode_window", slot.request_id,
                             f"K={self.window} emitted={n_emit} frozen_at={frozen}",
                             dur_ns=win_ns)

    def _unpack(self, host, emitted) -> None:
        """Unpack the window's [B, K*m + 1] matrix (m = spec_k + 1, so 1 for
        the plain window) by replaying the device's walk: a -1 inside a
        tick's m columns only pads past that tick's accepted length, so the
        walk goes tick by tick and stops a stream only where the host's own
        completion test (same counter, cap and eos) fires, which is where
        the device froze it. Feeds the host history mirror, also while
        speculation is paused, and with speculation on the draft counters of
        the serving metrics (drafted = spec_k a live verify pass, accepted =
        its emissions less the bonus token)."""
        m = self.spec_k + 1
        sm = self.serving_metrics if self.spec_k else None
        for b, slot in enumerate(self.slots):
            if slot is None or not self._decode[b]:
                continue
            done = False
            for t in range(self.window):
                got = 0
                for i in range(m):
                    token = int(host[b, t * m + i])
                    if token < 0:
                        break
                    got += 1
                    slot.emitted += 1
                    if self._spec_cfg:
                        self._hist[b].append(token)
                    done = slot.emitted >= slot.max_new or (
                        self.eos is not None and token == self.eos
                    )
                    emitted.append((slot.request_id, token, done))
                    if done:
                        break
                if sm is not None and got:
                    sm.spec_drafted += self.spec_k
                    sm.spec_accepted += got - 1
                    sm.spec_accept_len.observe(got)
                if done:
                    self._free_slot(b)
                    break


class _SleepingWindow:
    """A window runner that sleeps on the host after the device finished
    its window: ``tick_sleep_s`` times the engine's live K."""

    def __init__(self, runner, engine):
        self.runner = runner
        self.engine = engine

    def __call__(self, *args):
        out = self.runner(*args)
        if out[0].is_cuda:
            torch.cuda.current_stream(out[0].device).synchronize()
        time.sleep(self.engine.tick_sleep_s * self.engine.window)
        return out

    def __getattr__(self, name):  # captures, replays, launches of the runner
        return getattr(self.runner, name)


class _StubPagedEngine(PagedBatchEngine):
    """The stub's engine: every window runner it makes sleeps after its
    window when ``tick_sleep_s`` is set."""

    def __init__(self, *, tick_sleep_s: float = 0.0, **kwargs):
        self.tick_sleep_s = tick_sleep_s  # read by _wrap, which __init__ calls
        super().__init__(**kwargs)

    def _wrap(self, window, spec_k: int):
        runner = super()._wrap(window, spec_k)
        if runner is None or not self.tick_sleep_s:
            return runner
        return _SleepingWindow(runner, self)


def make_stub_paged_engine(*, max_slots: int = 4, max_seq: int = 64, page_size: int = 8,
                           chunk: int = 16, num_pages: int | None = None,
                           eos: int | None = None, window: int = 1, vocab: int = 97,
                           spec_k: int = 0, spec_ngram: int = 2, cycle: int | None = None,
                           prefix_cache: bool = False, prefix_cache_pages: int = 0,
                           flops_per_token: int = 1_000_000, peak_flops: float = 1e12,
                           lora_max_resident: int = 0, tick_sleep_s: float = 0.0,
                           chunk_sleep_s: float = 0.0, device=None,
                           graphs: bool | None = None) -> PagedBatchEngine:
    """A weight-free :class:`PagedBatchEngine` over the real window machinery
    (the counterpart of the JAX package's stub, which ``DORA_STUB_ENGINE=1``
    serves): the decode window is ``vlm.make_paged_window`` (or, with
    ``spec_k``, ``make_paged_spec_window``) with the model's batched step
    replaced by the affine rule ``next = (7 * t + 3) % vocab``, which the
    chunk-prefill stub applies too. Streams are deterministic and the same
    at every window size and speculation width, and every scheduler path
    (page grants, chunked prefill, freezing mid-window, preemption) is the
    engine's own. ``cycle`` swaps in the period-``cycle`` rule ``(t + 1) %
    cycle``, which prompt lookup predicts (acceptance near 1 after one
    period; the affine rule keeps it near 0).

    ``lora_max_resident > 0`` attaches an AdapterPool whose stub adapter is
    an int32 shift derived from the tenant name, and the rule becomes
    ``(rule(t) + shift) % vocab``: slot 0's zero shift keeps base streams
    those of the pool-less stub, each tenant gets its own stream.
    ``flops_per_token`` and ``peak_flops`` feed the device plane's ledger.
    The pools are one int32 placeholder: the rule reads no KV.

    ``tick_sleep_s`` stands in for a model's device cost: after each decode
    window has finished on the device, the host sleeps ``tick_sleep_s * K``
    (outside the window's graph, so every replay pays it); ``chunk_sleep_s``
    does the same after each prefill chunk's dispatch. The measurement
    tools' stub legs use them, as the JAX stub's arguments of those names."""
    from dora_tpu_torch.models.lora_pool import AdapterPool
    from dora_tpu_torch.models.vlm import make_paged_spec_window, make_paged_window

    dev = resolve_device(device)
    if num_pages is None:
        num_pages = max_slots * (max_seq // page_size) + 1

    if cycle is None:
        def rule(t):
            return (t * 7 + 3) % vocab
    else:
        def rule(t):
            return (t + 1) % cycle

    lora_pool = None
    if lora_max_resident:
        def stub_loader(name):
            # The tenant name is the adapter: no weight files, and the same
            # name resolves to the same shift in every process.
            return torch.tensor((sum(ord(c) for c in name) * 131 + 17) % vocab,
                                dtype=torch.int32, device=dev)

        lora_pool = AdapterPool(stub_loader, torch.tensor(0, dtype=torch.int32, device=dev),
                                max_resident=lora_max_resident)

        def step_fn(tokens, pools, positions, bts, adapters, shifts):
            return (rule(tokens) + shifts[adapters.long()]) % vocab, pools

        def spec_step_fn(chunks, pools, positions, bts, adapters, shifts):
            return (rule(chunks) + shifts[adapters.long()][:, None]) % vocab, pools

        def chunk_fn(ids, pools, position, bt, adapter, shifts):
            return (rule(ids) + shifts[adapter]) % vocab, pools
    else:
        def step_fn(tokens, pools, positions, bts):
            return rule(tokens), pools

        def spec_step_fn(chunks, pools, positions, bts):
            return rule(chunks), pools

        def chunk_fn(ids, pools, position, bt):
            return rule(ids), pools

    def window_factory(k, sk):
        if sk:
            return make_paged_spec_window(spec_step_fn, k=k, spec_k=sk, ngram=spec_ngram,
                                          eos=eos, lora=lora_pool is not None)
        return make_paged_window(step_fn, k=k, eos=eos, lora=lora_pool is not None)

    if chunk_sleep_s:
        chunk_body = chunk_fn

        def chunk_fn(*args):
            out = chunk_body(*args)
            time.sleep(chunk_sleep_s)
            return out

    engine = _StubPagedEngine(
        tick_sleep_s=tick_sleep_s,
        init_pool=lambda n: {"0": {"null": torch.zeros((1,), dtype=torch.int32, device=dev)}},
        chunk_prefill=chunk_fn, window_step=window_factory(window, spec_k),
        window_factory=window_factory, max_slots=max_slots, max_seq=max_seq,
        page_size=page_size, chunk=chunk, num_pages=num_pages, eos=eos, window=window,
        spec_k=spec_k, spec_ngram=spec_ngram, prefix_cache=prefix_cache,
        prefix_cache_pages=prefix_cache_pages, lora_pool=lora_pool, device=dev,
        graphs=graphs)
    engine.flops_per_token = flops_per_token
    engine.device_peak_flops = peak_flops
    return engine
