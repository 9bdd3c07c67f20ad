"""The device mesh and the sharding helpers, on torch.distributed.

Counterpart of dora_tpu/parallel/mesh.py. The JAX package's mesh is one
process over many devices, and XLA splits every array it places; here each
rank is one process on one device, so a :class:`Mesh` is this rank's view of
the (dp, tp, sp) grid of global ranks: its coordinates and one process group
per axis (the ranks that differ from it along that axis only). ``shard`` and
``shard_params`` return this rank's local shard of a global tensor, where
the JAX package returns the global array placed.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

AXIS_DP = "dp"  # data (batch)
AXIS_TP = "tp"  # tensor (heads / ffn hidden)
AXIS_SP = "sp"  # sequence (ring attention)

AXES = (AXIS_DP, AXIS_TP, AXIS_SP)


class Mesh:
    """This rank's place on a (dp, tp, sp) grid of global ranks.

    ``devices`` [dp, tp, sp] holds the ranks, ``shape`` maps each axis to
    its size (as the JAX mesh's ``shape`` does), ``index(axis)`` is this
    rank's coordinate and ``group(axis)`` the process group of its axis
    (None only on a mesh built without torch.distributed, where every axis
    has one rank, or for placement alone, as the tests build one)."""

    def __init__(self, devices, rank: int, groups: dict | None = None):
        self.devices = np.asarray(devices).reshape(np.shape(devices))
        if self.devices.ndim != len(AXES):
            raise ValueError(f"devices must be a [dp, tp, sp] grid, got {self.devices.shape}")
        self.rank = int(rank)
        where = np.argwhere(self.devices == self.rank)
        if not len(where):
            raise ValueError(f"rank {self.rank} is not on the mesh {self.devices.tolist()}")
        self.shape = dict(zip(AXES, map(int, self.devices.shape)))
        self.coords = dict(zip(AXES, map(int, where[0])))
        self._groups = dict(groups or {})

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        """The process group of ``axis``, or None where there is none."""
        g = self._groups.get(axis)
        if g is None and self.size(axis) > 1:
            raise RuntimeError(f"mesh axis {axis!r} has {self.size(axis)} ranks but no "
                               "process group (a placement-only mesh)")
        return g

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, coords={self.coords})"


def _live() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def make_mesh(dp: int = 1, tp: int = 1, sp: int = 1, devices=None) -> Mesh:
    """Build this rank's mesh with named axes (dp, tp, sp). Axis sizes must
    multiply to the rank count; pass dp=-1 to absorb the remainder into data
    parallelism. ``devices`` lists the global ranks of the mesh in increasing
    order (default: every rank of torch.distributed's world, or the one rank
    of a process that did not initialize it). Every rank of the world calls
    this with the same arguments: the axis groups are created collectively."""
    live = _live()
    if devices is None:
        import torch.distributed as dist

        devices = range(dist.get_world_size() if live else 1)
    devices = [int(d) for d in devices]
    n = len(devices)
    if dp == -1:
        if n % (tp * sp):
            raise ValueError(f"{n} devices not divisible by tp*sp={tp * sp}")
        dp = n // (tp * sp)
    if dp * tp * sp != n:
        raise ValueError(f"dp*tp*sp={dp * tp * sp} != {n} devices")
    if devices != sorted(set(devices)):
        raise ValueError(f"devices must be distinct ranks in increasing order, got {devices}")
    grid = np.array(devices).reshape(dp, tp, sp)
    if not live:
        if n != 1:
            raise ValueError(f"a mesh of {n} ranks needs torch.distributed initialized")
        return Mesh(grid, devices[0])
    import torch.distributed as dist

    rank = dist.get_rank()
    groups = {}
    for a, axis in enumerate(AXES):
        lines = np.moveaxis(grid, a, -1).reshape(-1, grid.shape[a])
        for ranks in lines.tolist():  # every rank creates every group, in one order
            g = dist.new_group(ranks)
            if rank in ranks:
                groups[axis] = g
    return Mesh(grid, rank, groups)


def _parts(spec, ndim: int) -> list:
    spec = tuple(spec) + (None,) * (ndim - len(spec))
    return [(axes if isinstance(axes, tuple) else (axes,)) if axes is not None else ()
            for axes in spec]


def _divisible(shape, spec, mesh: Mesh) -> bool:
    """A dimension splits over the PRODUCT of its mesh axes."""
    for dim, axes in zip(shape, _parts(spec, len(shape))):
        total = 1
        for axis in axes:
            total *= mesh.size(axis)
        if dim % total:
            return False
    return True


def shard(x: torch.Tensor, mesh: Mesh, *spec) -> torch.Tensor:
    """This rank's block of the global tensor ``x`` under ``spec`` (one entry
    a dimension: None, an axis name, or a tuple of axes whose product splits
    it, major to minor), as a contiguous tensor of its own."""
    index = []
    for dim, axes in zip(x.shape, _parts(spec, x.dim())):
        total, at = 1, 0
        for axis in axes:
            total *= mesh.size(axis)
            at = at * mesh.size(axis) + mesh.index(axis)
        if dim % total:
            raise ValueError(f"dimension {dim} does not split over {axes} ({total} ranks)")
        step = dim // total
        index.append(slice(at * step, (at + 1) * step))
    return x.detach()[tuple(index)].clone(memory_format=torch.contiguous_format)


def shard_params(params: Any, mesh: Mesh, rules) -> Any:
    """This rank's shards of a parameter tree (dicts, tuples, lists).

    ``rules`` is a list of ``(name, spec)`` matched against the leaf's FINAL
    path component exactly ('embed' must not shard 'pos_embed'). First match
    wins; the default is full replication, and a matched leaf whose
    dimension does not divide the mesh axis replicates instead of failing.
    Every leaf is a new tensor (a copy where it replicates)."""

    def place(name: str, leaf):
        for match, spec in rules:
            if name == match:
                if not _divisible(leaf.shape, spec, mesh):
                    break  # replicate: the shape does not tile on this mesh
                return shard(leaf, mesh, *spec)
        return leaf.detach().clone()

    def walk(tree, name=""):
        if isinstance(tree, dict):
            return {k: walk(v, str(k)) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):  # a sequence item has no name to match
            return type(tree)(walk(v) for v in tree)
        return place(name, tree)

    return walk(params)


__all__ = ["AXES", "AXIS_DP", "AXIS_SP", "AXIS_TP", "Mesh", "make_mesh", "shard",
           "shard_params"]
