"""Collectives over one axis of a :class:`~dora_tpu_torch.parallel.mesh.Mesh`,
plain and differentiable.

The JAX package gets these from XLA (``psum``, ``pmax``, ``pmin``,
``ppermute``, ``all_to_all`` and the collectives its shardings imply); the
port calls torch.distributed on the axis's process group. The
differentiable ones follow one convention: every rank of a tensor-parallel
group computes the same loss, so a gradient is never summed over copies of
it. Megatron's pair is :func:`copy_to` (identity forward, all-reduce of the
gradient) in front of a column-parallel product and :func:`reduce_from`
(all-reduce forward, identity backward) behind a row-parallel one;
:func:`gather` and :func:`split` move between a replicated tensor and this
rank's slice of it. (``torch.distributed.nn.functional``'s all-reduce
all-reduces its gradient too: it counts every rank's copy of the loss.)
:func:`ring_shift` rotates tensors around the axis, its gradient the other
way, as JAX's autodiff of ``ppermute`` does; :func:`all_to_all` is the tiled
``all_to_all`` of Ulysses, its gradient the inverse exchange.

On an axis of one rank without a group every one of them is the identity.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _group(mesh, axis: str):
    return None if mesh is None else mesh.group(axis)


def all_reduce(x: torch.Tensor, mesh, axis: str, op: str = "sum") -> torch.Tensor:
    """The all-reduce (``sum``, ``max`` or ``min``) of ``x`` over ``axis``,
    as a new tensor; not differentiable."""
    g = _group(mesh, axis)
    if g is None:
        return x
    out = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=getattr(dist.ReduceOp, op.upper()), group=g)
    return out


def _gather_dim(x: torch.Tensor, g, dim: int) -> torch.Tensor:
    parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
             for _ in range(dist.get_world_size(g))]
    dist.all_gather(parts, x.contiguous(), group=g)
    return torch.cat(parts, dim=dim)


def _slice(x: torch.Tensor, g, dim: int) -> torch.Tensor:
    return x.chunk(dist.get_world_size(g), dim=dim)[dist.get_rank(g)].contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        ctx.g = g
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.g)
        return grad, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=g)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim = g, dim
        return _gather_dim(x, g, dim)

    @staticmethod
    def backward(ctx, grad):
        return _slice(grad, ctx.g, ctx.dim), None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, dim):
        ctx.g, ctx.dim = g, dim
        return _slice(x, g, dim)

    @staticmethod
    def backward(ctx, grad):
        return _gather_dim(grad, ctx.g, ctx.dim), None, None


def copy_to(x, mesh, axis: str):
    """Identity forward; the gradient all-reduced over ``axis`` (the input of
    a column-parallel product)."""
    g = _group(mesh, axis)
    return x if g is None else _CopyTo.apply(x, g)


def reduce_from(x, mesh, axis: str):
    """All-reduce SUM over ``axis`` forward; the gradient passed through (the
    output of a row-parallel product)."""
    g = _group(mesh, axis)
    return x if g is None else _ReduceFrom.apply(x, g)


def gather(x, mesh, axis: str, dim: int = -1):
    """The ranks' slices of ``axis`` concatenated along ``dim`` in rank
    order; the gradient is this rank's slice."""
    g = _group(mesh, axis)
    return x if g is None else _Gather.apply(x, g, dim)


def split(x, mesh, axis: str, dim: int = -1):
    """This rank's slice of ``x`` along ``dim``; the gradient gathered."""
    g = _group(mesh, axis)
    return x if g is None else _Split.apply(x, g, dim)


def _shift(xs, g, shift: int):
    n, r = dist.get_world_size(g), dist.get_rank(g)
    dst = dist.get_global_rank(g, (r + shift) % n)
    src = dist.get_global_rank(g, (r - shift) % n)
    outs, ops = [], []
    for x in xs:
        x = x.contiguous()
        out = torch.empty_like(x)
        ops += [dist.P2POp(dist.isend, x, dst, g), dist.P2POp(dist.irecv, out, src, g)]
        outs.append(out)
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return outs


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, *xs):
        ctx.g = g
        return tuple(_shift(xs, g, 1))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *_shift(grads, ctx.g, -1))


def ring_shift(xs, mesh, axis: str):
    """Each tensor of ``xs`` sent to the next rank of ``axis`` (index + 1,
    wrapping) and received from the previous one, in one
    ``batch_isend_irecv``; the gradients travel the other way."""
    g = _group(mesh, axis)
    if g is None:
        return tuple(xs)
    return _RingShift.apply(g, *xs)


def _a2a(x, g, split_dim: int, concat_dim: int):
    n = dist.get_world_size(g)
    send = torch.stack(x.chunk(n, dim=split_dim))
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=g)
    return torch.cat(recv.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, g, split_dim, concat_dim):
        ctx.g, ctx.dims = g, (split_dim, concat_dim)
        return _a2a(x, g, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, grad):
        split_dim, concat_dim = ctx.dims
        return _a2a(grad, ctx.g, concat_dim, split_dim), None, None, None


def all_to_all(x, mesh, axis: str, split_dim: int, concat_dim: int):
    """JAX's tiled ``all_to_all``: ``x`` cut into one block a rank along
    ``split_dim``, block j sent to rank j, the blocks received concatenated
    along ``concat_dim`` in rank order; the gradient the inverse exchange."""
    g = _group(mesh, axis)
    return x if g is None else _AllToAll.apply(x, g, split_dim, concat_dim)


__all__ = ["all_reduce", "all_to_all", "copy_to", "gather", "reduce_from", "ring_shift",
           "split"]
