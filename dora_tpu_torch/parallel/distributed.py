"""Joining the ranks of a distributed run through the DORA_JAX_* contract.

Counterpart of dora_tpu/parallel/distributed.py. The variables keep the
JAX package's meaning; the port reads them for ``torch.distributed``:

  DORA_JAX_COORDINATOR   host:port of rank 0 (the rendezvous)
  DORA_JAX_NUM_PROCESSES the world size
  DORA_JAX_PROCESS_ID    this process's rank

One process drives one device, so the world size is the device count. The
backend is NCCL for a cuda device and gloo for the CPU.
"""

from __future__ import annotations

import logging
import os

from dora_tpu_torch._device import resolve_device

logger = logging.getLogger(__name__)


def maybe_init_distributed(device=None) -> bool:
    """Initialize torch.distributed from the env contract if it is set.

    Returns True when the process is part of a distributed run (after the
    init, or when torch.distributed was already initialized), False when it
    runs alone. Idempotent. ``device`` (default cuda) picks the backend."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return True
    coordinator = os.environ.get("DORA_JAX_COORDINATOR")
    if not coordinator:
        return False
    world = int(os.environ.get("DORA_JAX_NUM_PROCESSES", "1"))
    rank = int(os.environ.get("DORA_JAX_PROCESS_ID", "0"))
    backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=world, rank=rank)
    logger.info("torch.distributed up (%s): rank %d/%d", backend, rank, world)
    return True


def global_mesh(dp: int = -1, tp: int = 1, sp: int = 1, device=None):
    """A mesh over every rank of the run: call it on every rank. It joins
    the run first (:func:`maybe_init_distributed`)."""
    from dora_tpu_torch.parallel.mesh import make_mesh

    maybe_init_distributed(device)
    return make_mesh(dp=dp, tp=tp, sp=sp)


__all__ = ["global_mesh", "maybe_init_distributed"]
