"""Parallelism on torch.distributed: meshes, sharding, sequence-parallel
attention and the tensor-parallel fused decode.

Counterpart of dora_tpu/parallel/. Each rank is one process on one device
with named mesh axes

  * ``dp`` - data parallel (batch),
  * ``tp`` - tensor parallel (heads / ffn hidden, Megatron layout),
  * ``sp`` - sequence parallel (ring or Ulysses attention).

Where XLA inserts the collectives from sharding annotations in the JAX
package, the port calls them itself (``comm``) on each axis's process group.
"""

from dora_tpu_torch.parallel.mesh import (
    AXIS_DP,
    AXIS_SP,
    AXIS_TP,
    Mesh,
    make_mesh,
    shard,
    shard_params,
)
from dora_tpu_torch.parallel.ring import ring_attention
from dora_tpu_torch.parallel.ulysses import ulysses_attention

__all__ = [
    "AXIS_DP",
    "AXIS_TP",
    "AXIS_SP",
    "Mesh",
    "make_mesh",
    "shard",
    "shard_params",
    "ring_attention",
    "ulysses_attention",
]
