"""Continuous batching over a paged KV pool, on torch tensors.

Counterpart of ``PageAllocator`` and ``PagedBatchEngine`` of
dora_tpu/models/batch_engine.py: the same scheduling (one prefill chunk for
the stream at the head of the line, then one K-tick decode window per
:meth:`PagedBatchEngine.step`), the same page grants, the null page 0, the
block tables and the first token read from the final chunk at
``true_len - 1 - base``. Not ported yet: speculative decoding, LoRA, the
prefix cache, checkpoint/restore, preemption, window retuning and the
tracer/metrics hooks.
"""

from __future__ import annotations

from collections import Counter, deque
from dataclasses import dataclass

import numpy as np
import torch

from dora_tpu_torch._device import resolve_device


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

    def alloc(self, n: int) -> list[int] | None:
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._ref[p] = 1
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        return pages

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


class PagedBatchEngine:
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
    """

    def __init__(self, *, init_pool, chunk_prefill, window_step,
                 max_slots: int = 16, max_seq: int, page_size: int,
                 chunk: int, num_pages: int, eos: int | None = None,
                 window: int = 8, device=None):
        if page_size % 8 or chunk % page_size or max_seq % chunk or window < 1:
            raise ValueError(
                f"page {page_size} (multiple of 8), chunk {chunk} (multiple "
                f"of page), max_seq {max_seq} (multiple of chunk), window "
                f"{window} (>= 1)"
            )
        dev = resolve_device(device)
        self.device = dev
        self.max_slots = max_slots
        self.max_seq = max_seq
        self.page_size = page_size
        self.chunk = chunk
        self.eos = eos
        self.chunk_prefill = chunk_prefill
        self.window_step = window_step
        self.window = window
        self.max_pages = max_seq // page_size
        self.pools = init_pool(num_pages)
        self.allocator = PageAllocator(num_pages)
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
        # Per-slot device vectors carried through the window, rebuilt from
        # the host slots only when membership changes.
        self._emitted_dev = torch.zeros((max_slots,), dtype=torch.int32, device=dev)
        self._maxnew_dev = torch.zeros((max_slots,), dtype=torch.int32, device=dev)
        self._members_dirty = True
        #: prefill chunks run
        self.chunks_run = 0
        #: host->device program dispatches / device->host token copies
        self.dispatches = 0
        self.fetches = 0

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

    def fits(self, prompt_len: int, max_new: int) -> bool:
        """Admissible EVER: the length fits the block table and the whole
        pool could grant its pages."""
        return (
            prompt_len + max_new <= self.max_seq
            and self.pages_needed(prompt_len, max_new) <= self.allocator.num_pages - 1
        )

    def pages_needed(self, prompt_len: int, max_new: int) -> int:
        """Pages a stream can touch end to end: the chunk-padded prefill
        writes (whole pages) or prompt + max_new decode rows, whichever
        reaches further."""
        chunk_rows = -(-prompt_len // self.chunk) * self.chunk
        rows = max(chunk_rows, prompt_len + max_new)
        return -(-rows // self.page_size)

    def can_admit(self, prompt_len: int, max_new: int) -> bool:
        return (
            self.free_slots > 0
            and self.fits(prompt_len, max_new)
            and self.pages_needed(prompt_len, max_new) <= self.free_pages
        )

    def submit(self, request_id: str, prompt_ids, max_new: int) -> None:
        """Admit a stream: grant its pages, write its block table and queue
        its prefill. The first token comes from a later :meth:`step`."""
        ids = [int(t) for t in prompt_ids]
        if not ids:
            raise ValueError("empty prompt")
        if not self.can_admit(len(ids), max_new):
            raise RuntimeError(
                f"cannot admit: {self.free_slots} slots, {self.free_pages} "
                f"pages free vs {self.pages_needed(len(ids), max_new)} needed "
                f"({len(ids)}+{max_new}, max_seq {self.max_seq})"
            )
        b = self.slots.index(None)
        pages = self.allocator.alloc(self.pages_needed(len(ids), max_new))
        self._bt[b, :] = 0
        self._bt[b, : len(pages)] = pages
        self.slots[b] = _PagedSlot(
            request_id, emitted=0, max_new=max_new, pages=pages, prompt=ids,
            true_len=len(ids),
        )
        self._decode[b] = False
        self._prefillq.append(b)
        self._bt_dirty = True

    def _free_slot(self, b: int) -> None:
        self.allocator.unref(self.slots[b].pages)
        self._bt[b, :] = 0
        self.slots[b] = None
        self._decode[b] = False
        self._bt_dirty = True
        self._members_dirty = True

    def check_invariants(self) -> None:
        """Allocator bookkeeping plus custody: every allocated page's
        refcount equals the number of live slots holding it."""
        self.allocator.check_invariants()
        held: Counter = Counter()
        for s in self.slots:
            if s is not None:
                held.update(s.pages)
        for p, n in held.items():
            rc = self.allocator.refcount(p)
            assert rc == n, f"page {p}: refcount {rc} != {n} holders"
        assert self.allocator.in_use == len(held), (
            f"{self.allocator.in_use} pages in use but only {len(held)} held"
        )

    # -- the interleaved step ------------------------------------------------

    def step(self) -> list[tuple[str, int, bool]]:
        """One scheduler tick: one prefill chunk for the head-of-line
        prefilling stream, then one K-tick decode window for every decoding
        stream. Returns [(request_id, token, done)] in stream order."""
        dev = self.device
        emitted: list[tuple[str, int, bool]] = []

        if self._prefillq:
            b = self._prefillq[0]
            s = self.slots[b]
            base = s.chunk_base
            piece = s.prompt[base : base + self.chunk]
            piece = piece + [0] * (self.chunk - len(piece))
            greedy, self.pools = self.chunk_prefill(
                torch.tensor(piece, dtype=torch.int32, device=dev), self.pools,
                base, torch.from_numpy(self._bt[b].copy()).to(dev),
            )
            s.chunk_base = base + self.chunk
            self.chunks_run += 1
            self.dispatches += 1
            if s.chunk_base >= s.true_len:  # final chunk: the stream starts
                self._prefillq.popleft()
                s.prompt = None
                token = int(greedy[s.true_len - 1 - base].item())
                self.fetches += 1
                s.emitted = 1
                done = (self.eos is not None and token == self.eos) or s.max_new <= 1
                emitted.append((s.request_id, token, done))
                if done:
                    self._free_slot(b)
                else:
                    self._decode[b] = True
                    self.tokens[b] = token
                    self.positions[b] = s.true_len
                    self._members_dirty = True
                    self._bt_dirty = True

        if any(self._decode):
            if self._members_dirty:
                live = [s is not None and self._decode[i] for i, s in enumerate(self.slots)]
                self._mask = torch.tensor(self._decode, dtype=torch.bool, device=dev)
                self._emitted_dev = torch.tensor(
                    [s.emitted if ok else 0 for s, ok in zip(self.slots, live)],
                    dtype=torch.int32, device=dev,
                )
                self._maxnew_dev = torch.tensor(
                    [s.max_new if ok else 0 for s, ok in zip(self.slots, live)],
                    dtype=torch.int32, device=dev,
                )
                self._members_dirty = False
            if self._bt_dirty:
                dec = self._bt * np.asarray(self._decode, np.int32)[:, None]
                self._bt_dec = torch.from_numpy(dec).to(dev)
                self._bt_dirty = False
            (
                mat,
                self.tokens,
                self.positions,
                self._mask,
                self._emitted_dev,
                self.pools,
            ) = self.window_step(
                self.tokens, self.pools, self.positions, self._bt_dec,
                self._mask, self._emitted_dev, self._maxnew_dev,
            )
            self.dispatches += 1
            host = mat.cpu().numpy()  # ONE [B, K+1] device->host copy
            self.fetches += 1
            for b, slot in enumerate(self.slots):
                if slot is None or not self._decode[b]:
                    continue
                # The host completion test mirrors the device's (same
                # counter, cap and eos), so the first host-done token is
                # where the device froze the row; later columns hold -1.
                for j in range(self.window):
                    token = int(host[b, j])
                    if token < 0:
                        break
                    slot.emitted += 1
                    done = slot.emitted >= slot.max_new or (
                        self.eos is not None and token == self.eos
                    )
                    emitted.append((slot.request_id, token, done))
                    if done:
                        self._free_slot(b)
                        break
        return emitted
