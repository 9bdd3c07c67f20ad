"""Refcounted resident-adapter pool for multi-tenant LoRA serving.

Counterpart of dora_tpu/models/lora_pool.py, on torch tensors. The engine
serves many tenants, but the device holds only ``max_resident`` adapter
weight sets at once:

* a fixed device STACK of ``max_resident + 1`` adapter slots per weight
  leaf, slot 0 the reserved all-zeros base (adapter-less rows gather slot 0
  and get an exact zero delta). The stack's shape never changes; admission
  and eviction rewrite slot contents in place (``index_copy_`` on the
  device stack, where the JAX package runs a donated scatter);
* ``acquire(name)`` refcounts residency per live stream: a resident adapter
  bumps its refcount and LRU stamp; a non-resident one loads into a free
  slot, evicting the least-recently-used refcount-0 resident if the pool is
  full. An adapter pinned by live streams is never swapped out. Returns
  ``None`` when every slot is pinned: the admission-control signal;
* ``fits(name)`` answers admission without side effects.

``loader(name)`` returns the adapter's weights shaped like one stack slot
(``{"a": [L, D, r], "b": [L, r, D]}`` for the fused decode path); the pool
is agnostic to what an adapter is.
"""

from __future__ import annotations

import itertools

import torch


def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


class AdapterPool:
    """See the module docstring. One instance per PagedBatchEngine; every
    method runs on the scheduler thread."""

    def __init__(self, loader, template, *, max_resident: int,
                 known: set[str] | None = None):
        """``template`` is one zero slot of the stack (a tensor or a dict of
        tensors, on the device the stack should live on); the resident
        stack holds ``max_resident + 1`` copies with slot 0 permanently
        zero. ``known`` is the servable catalog (None: every name is
        servable)."""
        if max_resident < 1:
            raise ValueError("need at least one resident adapter slot")
        self.loader = loader
        self.known = known
        self.max_resident = max_resident
        self._state = _tree_map(
            lambda leaf: torch.zeros((max_resident + 1, *torch.as_tensor(leaf).shape),
                                     dtype=torch.as_tensor(leaf).dtype,
                                     device=torch.as_tensor(leaf).device),
            template,
        )
        #: name -> resident slot index (1..max_resident)
        self._resident: dict[str, int] = {}
        self._refs: dict[str, int] = {}
        self._last_used: dict[str, int] = {}
        self._free = list(range(1, max_resident + 1))
        self._clock = itertools.count(1)
        #: cumulative loads and evictions
        self.loads = 0
        self.evictions = 0

    # -- admission -----------------------------------------------------------

    def slot_of(self, name: str | None) -> int | None:
        """Resident slot of ``name`` (0 for base/None), or None when not
        resident."""
        if not name:
            return 0
        return self._resident.get(name)

    def has(self, name: str | None) -> bool:
        """Is ``name`` servable at all (resident or in the catalog)? An
        unknown tenant is rejected up front, never parked."""
        if not name:
            return True
        return name in self._resident or self.known is None or name in self.known

    def fits(self, name: str | None) -> bool:
        """Could ``acquire(name)`` succeed now: resident, a free slot, or an
        evictable (refcount-0) resident."""
        if not name or name in self._resident or self._free:
            return True
        return any(self._refs.get(n, 0) == 0 for n in self._resident)

    def acquire(self, name: str | None) -> int | None:
        """Pin ``name`` resident for one stream and return its slot (0 for
        base: never loaded, never refcounted). Loads and, if needed, evicts
        the LRU refcount-0 resident; None when every slot is pinned."""
        if not name:
            return 0
        idx = self._resident.get(name)
        if idx is None:
            idx = self._admit(name)
            if idx is None:
                return None
        self._refs[name] = self._refs.get(name, 0) + 1
        self._last_used[name] = next(self._clock)
        return idx

    def release(self, name: str | None) -> None:
        """Drop one stream's pin; the adapter stays resident (warm) until
        eviction needs its slot."""
        if not name or name not in self._refs:
            return
        self._refs[name] = max(0, self._refs[name] - 1)

    def _admit(self, name: str) -> int | None:
        if self._free:
            idx = self._free.pop()
        else:
            victim = min(
                (n for n in self._resident if self._refs.get(n, 0) == 0),
                key=lambda n: self._last_used.get(n, 0),
                default=None,
            )
            if victim is None:
                return None
            idx = self._resident.pop(victim)
            self._refs.pop(victim, None)
            self._last_used.pop(victim, None)
            self.evictions += 1
        def write(leaf, val):
            val = torch.as_tensor(val).to(device=leaf.device, dtype=leaf.dtype)
            leaf.index_copy_(0, torch.tensor([idx], device=leaf.device), val[None])

        _tree_map(write, self._state, self.loader(name))
        self._resident[name] = idx
        self.loads += 1
        return idx

    # -- the stack the fused window reads ------------------------------------

    def state(self):
        """The resident stack (slot axis first on every leaf); its shape
        never changes."""
        return self._state

    # -- introspection -------------------------------------------------------

    @property
    def resident(self) -> int:
        return len(self._resident)

    def adapter_bytes(self) -> int:
        """Device bytes of ONE adapter slot."""
        total = sum(t.numel() * t.element_size() for t in _leaves(self._state))
        return total // (self.max_resident + 1)

    def resident_bytes(self) -> int:
        return self.resident * self.adapter_bytes()

    def streams_by_adapter(self) -> dict[str, int]:
        """Live-stream pins per resident adapter."""
        return {n: self._refs.get(n, 0) for n in sorted(self._resident)}

    def stats(self) -> dict:
        return {
            "resident": self.resident,
            "max_resident": self.max_resident,
            "resident_bytes": self.resident_bytes(),
            "loads": self.loads,
            "evictions": self.evictions,
            "streams": self.streams_by_adapter(),
        }

    def check_invariants(self) -> None:
        assert len(self._resident) + len(self._free) == self.max_resident
        assert all(1 <= i <= self.max_resident for i in self._resident.values())
        assert len(set(self._resident.values())) == len(self._resident)
        for name, refs in self._refs.items():
            assert refs >= 0, (name, refs)
            assert name in self._resident or refs == 0
