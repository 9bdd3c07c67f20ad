"""Grouped (multi-tenant) LoRA delta, on torch tensors.

Counterpart of dora_tpu/ops/lora.py. Multi-tenant serving batches streams
of different adapters into one fused pass, so each row's low-rank delta

    y[i] = (x[i] @ A[g[i]]) @ B[g[i]]

gathers its adapter's factors out of the resident stacks ``A [S, D, r]`` /
``B [S, r, N]`` by the row's adapter id ``g [R]``. Slot 0 of the stacks is
all zeros by contract (models/lora_pool.py): base rows ride the same call
and get an exactly zero delta.

Two versions, as in ops/decode_block.py: :func:`lora_gather_matmul_plain`
(plain PyTorch, f32 products; the CPU path and the card's oracle) and the
hand-written CUDA kernel of ``csrc/lora.cu`` (rows grouped by adapter on
the device, both products on the tensor cores, two launches), which
:func:`lora_gather_matmul` launches for CUDA tensors (counted in its
``launches``, once a call). Nothing falls back: a CUDA tensor the kernel
does not take raises.
"""

from __future__ import annotations

import torch

from dora_tpu_torch.ops import _build

_SIGNATURES = {
    "lora": {
        "dora_lora_splits": [_build.I] * 4,
        "dora_lora_gather_matmul": [_build.P] * 4 + [_build.L] * 2 + [_build.P] * 2
        + [_build.I] * 5 + [_build.P],
    },
}

#: what the kernel takes (csrc/lora.cu: LMAXR, LMAXD)
KERNEL_MAX_RANK = 256
KERNEL_MAX_DIM = 8192


def kernel_shape_limits(rank: int, dim: int) -> list[str]:
    """The kernel's limits that adapters of ``rank`` on a model of width
    ``dim`` run into, each named; empty when the kernel takes them. The
    engine factory refuses such a catalog on the card before serving."""
    out = []
    if not 1 <= rank <= KERNEL_MAX_RANK:
        out.append(f"LoRA rank {rank}: the lora kernel takes rank 1..{KERNEL_MAX_RANK}")
    if dim > KERNEL_MAX_DIM:
        out.append(f"model width {dim}: the lora kernel takes width <= {KERNEL_MAX_DIM}")
    return out


def _check_groups(groups: torch.Tensor, slots: int) -> None:
    """Adapter ids of host tensors lie in [0, slots); on the card that is the
    caller's contract (reading it back would stall the stream)."""
    if groups.numel() and (int(groups.min()) < 0 or int(groups.max()) >= slots):
        raise ValueError(f"adapter ids must lie in [0, {slots})")


def lora_gather_matmul_plain(x, groups, a_stack, b_stack):
    """``(x[i] @ A[g_i]) @ B[g_i]`` per row in f32, returned in x.dtype:
    rows of one adapter go through one pair of products."""
    _check_groups(groups, a_stack.shape[0])
    out = torch.zeros((x.shape[0], b_stack.shape[-1]), dtype=torch.float32,
                      device=x.device)
    for u in torch.unique(groups).tolist():
        rows = groups == u
        t = x[rows].float() @ a_stack[u].float()
        out[rows] = t @ b_stack[u].float()
    return out.to(x.dtype)


def _slab_stride(t: torch.Tensor, name: str, inner: tuple[int, int]) -> int:
    """Slot stride (elements) of a [S, K, N] stack whose [K, N] slabs are
    contiguous: a layer's slice ``stack[:, i]`` of the [S, L, K, N] resident
    stack qualifies without a copy."""
    if t.dim() != 3 or tuple(t.shape[1:]) != inner:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected [S, {inner[0]}, {inner[1]}]")
    if t.stride(2) != 1 or t.stride(1) != inner[1]:
        raise ValueError(f"{name}: each slot's [{inner[0]}, {inner[1]}] slab must be contiguous")
    return t.stride(0)


def _lora_gather_matmul_kernel(x, groups, a_stack, b_stack, lib=None):
    dev = x.device
    rows, d = x.shape
    slots, _, rank = a_stack.shape
    n = b_stack.shape[-1]
    if x.dtype != torch.bfloat16 or a_stack.dtype != torch.bfloat16 or b_stack.dtype != torch.bfloat16:
        raise ValueError("lora kernel takes bf16 x and stacks, got "
                         f"{x.dtype}, {a_stack.dtype}, {b_stack.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if groups.dtype != torch.int32 or tuple(groups.shape) != (rows,) or not groups.is_contiguous():
        raise ValueError(f"groups must be contiguous int32 [{rows}]")
    if any(t.device != dev for t in (groups, a_stack, b_stack)):
        raise ValueError("x, groups and the stacks must lie on one device")
    if b_stack.shape[0] != slots:
        raise ValueError(f"A has {slots} slots, B {b_stack.shape[0]}")
    limits = kernel_shape_limits(rank, d)
    if limits:
        raise ValueError("lora kernel: " + "; ".join(limits))
    a_slot = _slab_stride(a_stack, "a_stack", (d, rank))
    b_slot = _slab_stride(b_stack, "b_stack", (rank, n))
    if not x.is_cuda:
        _check_groups(groups, slots)
    lib = lib if lib is not None else _build.library("lora", _SIGNATURES["lora"])
    y = torch.empty((rows, n), dtype=torch.bfloat16, device=dev)
    if rows == 0:
        return y
    # the first product's D splits, each row's f32 t partials summed by the second
    part = torch.empty((lib.dora_lora_splits(d, slots, rank, rows) * rows * rank,),
                       dtype=torch.float32, device=dev)
    rc = lib.dora_lora_gather_matmul(
        x.data_ptr(), groups.data_ptr(), a_stack.data_ptr(), b_stack.data_ptr(),
        a_slot, b_slot, y.data_ptr(), part.data_ptr(), rows, d, rank, n, slots,
        _build.stream_of(x),
    )
    lora_gather_matmul.launches += 1
    _build.check(rc, "lora_gather_matmul")
    return y


def lora_gather_matmul(x, groups, a_stack, b_stack):
    """``(x[i] @ A[g_i]) @ B[g_i]`` per row, gathered by adapter id.

    x [R, D]; groups [R] int32 in [0, S); a_stack [S, D, r]; b_stack
    [S, r, N] (each slot's slab contiguous; a layer's slice of the
    [S, L, ...] resident stack is taken as it is). Returns [R, N] in
    x.dtype from f32 accumulation; slot 0 must be the all-zeros base slot,
    whose rows get an exactly zero delta."""
    if not x.is_cuda:
        return lora_gather_matmul_plain(x, groups, a_stack, b_stack)
    return _lora_gather_matmul_kernel(x, groups, a_stack, b_stack)


lora_gather_matmul.launches = 0


def reset_launches() -> None:
    lora_gather_matmul.launches = 0
