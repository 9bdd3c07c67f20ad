"""Radix prefix cache over the paged KV pool (RadixAttention-style).

The port's own copy of dora_tpu/models/prefix_cache.py (host-only, no
tensors): the same tree, custody rules, eviction order, hash chains and
counters, working on this package's ``PageAllocator``. The port imports
nothing of dora_tpu, so it keeps this copy; tests/test_torch_prefix_cache.py
holds the two against each other on identical operation sequences.

Millions of requests open with the same system prompt / few-shot
template; every admission used to re-prefill and re-store those rows.
This cache turns cross-request prefix reuse into an admission-time
lookup: a radix tree keyed on PAGE-GRANULARITY token-id chunks, where
each node owns one physical KV page whose ``page_size`` rows hold
exactly the KV of that chunk, computed once by whichever stream got
there first.

Custody is refcounts, not copies (models/batch_engine.PageAllocator):

* ``insert`` adopts a completed prompt's fully-populated pages — the
  cache takes ONE allocator reference per new node, so the pages
  outlive the stream that computed them.
* ``lookup`` walks the longest cached page-aligned prefix of a new
  prompt; the engine refs those pages into the new stream's block
  table and starts prefill at the divergence point. Shared pages are
  immutable: chunk prefill and decode only ever write rows past the
  shared prefix, which land in the stream's own fresh pages (the
  copy-on-write boundary page is re-materialized by the divergence
  chunk, never written in place — no kernel changes).
* ``evict`` drops unpinned, unshared pages LRU-leaf-first when the
  pool is under admission pressure. Eviction yields to admission —
  cached pages are a bonus, never a reason to shed — and a page still
  shared with a live stream (refcount > 1) is in active use, so it is
  never evicted out from under the stream; dropping the cache's
  reference to it would not free a page anyway.
* ``pin``/``unpin`` protect a preempted victim's prefix path from
  eviction while it waits to resume (refcount custody, not slot
  custody): resume re-prefills only the unshared tail.

Token ids are exact-match keys (no hashing, no collisions): two
prompts share a node only when their page-size chunk of token ids is
identical, which is the greedy-exactness contract.

The fleet plane additionally needs a *bounded, shippable* summary of
what this cache holds, so a router can longest-prefix-match a prompt
against remote replicas without shipping the tree. Every node carries a
cumulative **hash chain** — ``blake2b(parent_chain || chunk token ids)``
with the root seeded from the adapter identity, computed once at insert
time (incremental, never re-walked) — and ``digest`` exports the top-N
most-recently-used paths as ``(chain, token_len, pages)`` tuples. The
hash is deterministic across processes (never Python's salted builtin
``hash``), so a router hashing a prompt with ``prompt_hash_chain``
produces byte-identical chains to compare against any replica's digest.
Within the tree itself, hashing plays no role in correctness: matching
stays exact on token ids.

Multi-tenant LoRA serving adds an ``adapter`` dimension to that
contract: the KV a stream computes depends on its adapter's weights,
so two tenants with byte-identical prompts must NEVER share pages.
The cache therefore keys every path on ``(adapter, tokens)`` — one
radix root per adapter identity (the stable tenant NAME, not the
resident slot index, which is recycled by eviction) — and eviction /
accounting walk all roots.
"""

from __future__ import annotations

import hashlib
import itertools


def _root_chain(adapter: str | None) -> str:
    """Chain seed for an adapter's radix root. Seeding from the tenant
    identity means two tenants' byte-identical prompts hash to different
    chains — the digest inherits the cache's isolation contract."""
    h = hashlib.blake2b(b"dora-prefix-root:", digest_size=8)
    h.update((adapter or "").encode())
    return h.hexdigest()


def _chain_hash(parent_chain: str, key) -> str:
    """One incremental chain step: hash the parent's cumulative chain
    plus this chunk's token ids. Deterministic across processes."""
    h = hashlib.blake2b(digest_size=8)
    h.update(parent_chain.encode())
    for t in key:
        h.update(int(t).to_bytes(8, "little", signed=True))
    return h.hexdigest()


def prompt_hash_chain(ids, page_size: int, adapter: str | None = None):
    """Cumulative page-boundary chain of a prompt: one ``(chain,
    token_len)`` pair per full page-size chunk, byte-identical to the
    chains a replica's cache computes at insert. The router side of the
    digest contract — see ``PrefixCache.digest``."""
    chain = _root_chain(adapter)
    out: list[tuple[str, int]] = []
    ps = page_size
    for i in range(0, (len(ids) // ps) * ps, ps):
        chain = _chain_hash(chain, tuple(ids[i : i + ps]))
        out.append((chain, i + ps))
    return out


class _Node:
    __slots__ = (
        "key", "page", "children", "parent", "last_used", "pins", "chain",
    )

    def __init__(self, key: tuple, page: int | None, parent: "_Node | None",
                 chain: str = ""):
        self.key = key          # edge label: page_size token ids
        self.page = page        # physical page id (None only at root)
        self.children: dict[tuple, _Node] = {}
        self.parent = parent
        self.last_used = 0
        self.pins = 0
        self.chain = chain      # cumulative blake2b chain root..here


class PrefixCache:
    """See module docstring. One instance per PagedBatchEngine; all
    methods run on the scheduler thread (no locking)."""

    def __init__(self, allocator, page_size: int, *, max_pages: int = 0):
        self.allocator = allocator
        self.page_size = page_size
        #: optional hard cap on cached pages (0 = bounded only by pool
        #: pressure); insert evicts LRU past it
        self.max_pages = max_pages
        self._root = _Node((), None, None, _root_chain(None))
        #: adapter identity -> radix root; None/"" is the base tenant.
        #: Tenant isolation lives here: lookups only ever walk their
        #: own adapter's tree, so cross-tenant hits are structurally
        #: impossible.
        self._roots: dict[str | None, _Node] = {None: self._root}
        self._clock = itertools.count(1)
        #: pages (== nodes) currently held by the cache
        self.size = 0
        # -- accounting (cumulative; read through stats()) --
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0
        self.inserted_pages = 0
        self.evicted_pages = 0
        #: boundary pages re-materialized privately because the
        #: divergence point fell inside a cached page (mid-page
        #: divergence, or a fully-cached prompt re-running its final
        #: page to produce the first token)
        self.cow_copies = 0

    def _chunks(self, ids) -> list[tuple]:
        ps = self.page_size
        return [
            tuple(ids[i : i + ps])
            for i in range(0, (len(ids) // ps) * ps, ps)
        ]

    def _root_for(self, adapter: str | None, create: bool = False) -> _Node:
        root = self._roots.get(adapter or None)
        if root is None:
            root = _Node((), None, None, _root_chain(adapter or None))
            if create:
                self._roots[adapter or None] = root
        return root

    # -- lookup / insert -----------------------------------------------------

    def lookup(
        self, ids, adapter: str | None = None
    ) -> tuple[int, list[int], bool]:
        """Longest cached page-aligned prefix of ``ids``.

        Returns ``(matched_tokens, pages, mid_page)``: the matched
        length (a multiple of ``page_size``), the cached page ids in
        prefix order, and whether the divergence falls INSIDE the next
        cached page (some cached edge shares a proper prefix with the
        next chunk — the copy-on-write boundary case). Touches the
        matched path's LRU stamps; hit/miss accounting is the
        engine's, made against the prefix length it actually maps.
        ``adapter`` scopes the walk to that tenant's tree."""
        now = next(self._clock)
        node = self._root_for(adapter)
        pages: list[int] = []
        for key in self._chunks(ids):
            child = node.children.get(key)
            if child is None:
                break
            child.last_used = now
            pages.append(child.page)
            node = child
        matched = len(pages) * self.page_size
        tail = tuple(ids[matched : matched + self.page_size])
        mid_page = bool(tail) and any(
            k[0] == tail[0] for k in node.children
        )
        return matched, pages, mid_page

    def insert(self, ids, pages: list[int], adapter: str | None = None) -> int:
        """Adopt a completed prompt's fully-populated pages: one node
        per page-size chunk of ``ids``, each new node taking one
        allocator reference on its page. Existing nodes keep their
        page (first writer wins — the duplicate page stays private to
        its stream and frees with it). Returns pages adopted.
        ``adapter`` scopes adoption to that tenant's tree."""
        now = next(self._clock)
        node = self._root_for(adapter, create=True)
        new = 0
        for key, page in zip(self._chunks(ids), pages):
            child = node.children.get(key)
            if child is None:
                child = _Node(key, page, node, _chain_hash(node.chain, key))
                node.children[key] = child
                self.allocator.ref([page])
                self.size += 1
                new += 1
            child.last_used = now
            node = child
        self.inserted_pages += new
        if self.max_pages and self.size > self.max_pages:
            self.evict(self.size - self.max_pages)
        return new

    # -- pin / unpin (preempted victims) -------------------------------------

    def pin(self, ids, adapter: str | None = None) -> int:
        """Pin the cached path matching ``ids`` against eviction (one
        pin per node; nestable). Returns the pinned token length."""
        node = self._root_for(adapter)
        n = 0
        for key in self._chunks(ids):
            child = node.children.get(key)
            if child is None:
                break
            child.pins += 1
            n += self.page_size
            node = child
        return n

    def unpin(self, ids, adapter: str | None = None) -> None:
        """Release one pin along the matching path (tolerates a path
        shorter than at pin time — impossible while pinned, but unpin
        must never raise on teardown)."""
        node = self._root_for(adapter)
        for key in self._chunks(ids):
            child = node.children.get(key)
            if child is None:
                break
            if child.pins > 0:
                child.pins -= 1
            node = child

    # -- eviction (pool pressure) --------------------------------------------

    def evictable_pages(self) -> int:
        """Pages eviction could return to the free list RIGHT NOW:
        nodes that are unpinned, unshared (refcount 1 — only the cache
        holds them), and whose whole subtree is likewise evictable (a
        pinned or in-use descendant keeps its ancestors reachable).
        Admission counts these as free-in-waiting."""

        roots = set(self._roots.values())

        def walk(n: _Node) -> tuple[bool, int]:
            total = 0
            ok_all = True
            for c in n.children.values():
                ok, cnt = walk(c)
                total += cnt
                ok_all = ok_all and ok
            if n in roots:
                return True, total
            ok = (
                ok_all
                and n.pins == 0
                and self.allocator.refcount(n.page) == 1
            )
            return ok, total + (1 if ok else 0)

        return sum(walk(root)[1] for root in roots)

    def evict(self, need: int) -> int:
        """Free up to ``need`` pages, least-recently-used leaves first
        (a parent becomes a leaf once its children are gone, so cold
        branches unwind bottom-up). Skips pinned nodes and pages still
        shared with live streams. Returns pages actually freed."""
        freed = 0
        while freed < need:
            best: _Node | None = None
            stack = [
                c
                for root in self._roots.values()
                for c in root.children.values()
            ]
            while stack:
                n = stack.pop()
                stack.extend(n.children.values())
                if n.children or n.pins:
                    continue
                if self.allocator.refcount(n.page) != 1:
                    continue
                if best is None or n.last_used < best.last_used:
                    best = n
            if best is None:
                break
            del best.parent.children[best.key]
            self.allocator.unref([best.page])
            self.size -= 1
            freed += 1
        self.evicted_pages += freed
        return freed

    def flush(self) -> int:
        """Evict everything evictable (tests / shutdown)."""
        return self.evict(self.size)

    # -- introspection -------------------------------------------------------

    def pages(self):
        """Iterate every cached page id across all tenants (invariant
        checks)."""
        stack = [
            c
            for root in self._roots.values()
            for c in root.children.values()
        ]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            yield n.page

    def digest(self, top_n: int = 32) -> list[tuple[str, int, int]]:
        """Bounded fleet digest: the top-``top_n`` most-recently-used
        cached prefixes across all tenants, each as ``(chain,
        token_len, pages)``. Chains were computed incrementally at
        insert, so this is a walk plus a sort — no hashing here. A
        router matches a prompt by comparing ``prompt_hash_chain``
        output against these tuples (longest equal chain wins)."""
        entries: list[tuple[int, str, int]] = []
        stack = [
            (c, 1)
            for root in self._roots.values()
            for c in root.children.values()
        ]
        while stack:
            n, depth = stack.pop()
            stack.extend((c, depth + 1) for c in n.children.values())
            entries.append((n.last_used, n.chain, depth))
        entries.sort(reverse=True)
        return [
            (chain, depth * self.page_size, depth)
            for _, chain, depth in entries[:top_n]
        ]

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": round(self.hits / total, 4) if total else None,
            "hit_tokens": self.hit_tokens,
            "cached_pages": self.size,
            "inserted_pages": self.inserted_pages,
            "evicted_pages": self.evicted_pages,
            "cow_copies": self.cow_copies,
        }
