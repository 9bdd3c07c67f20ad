"""The operator tier of the port (dora_tpu/tpu/): torch operators, pure
``(state, inputs) -> (state, outputs)`` functions over tensors on one
device, hosted together in one runtime node (``dora_tpu_torch.runtime``)
whose sibling edges stay tensors on that device. Only the streams that
cross the node's boundary become Arrow messages."""

from dora_tpu_torch.tpu.api import DoraStatus, TorchOperator

__all__ = ["DoraStatus", "TorchOperator"]
