"""Arrow and host arrays to tensors on the device and back
(dora_tpu/tpu/bridge.py).

Tensor convention on the wire, the JAX package's: a 1-D Arrow primitive
array plus metadata ``shape`` (list of ints) and ``dtype``; scalars and 1-D
data need no metadata. Arrow has no bfloat16, so a bf16 tensor travels
widened to f32 with ``dtype`` "bfloat16", and is narrowed again on the way
in. pyarrow is imported only where a value is Arrow: the runtime also takes
numpy arrays and tensors (a scripted node's payloads) and hands its outputs
to the node as flat numpy arrays, which the node writes as Arrow."""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

SHAPE_KEY = "shape"
DTYPE_KEY = "dtype"

#: torch dtypes by their numpy names (the ``dtype`` metadata's spelling)
_TORCH_DTYPES = {
    "float32": torch.float32, "float64": torch.float64, "float16": torch.float16,
    "bfloat16": torch.bfloat16, "int8": torch.int8, "uint8": torch.uint8,
    "int16": torch.int16, "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
}
_DTYPE_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


def _is_arrow(value: Any) -> bool:
    return type(value).__module__.split(".")[0] == "pyarrow"


def arrow_to_host(value: Any, metadata: dict | None = None) -> np.ndarray:
    """An Arrow array (or a numpy array) as numpy, without a copy where the
    type allows, reshaped by the ``shape`` metadata and cast to its
    ``dtype``. A string array becomes the utf-8 bytes of its entries joined
    by spaces, as uint8, so text flows into byte-level tokenizing operators.
    ``dtype`` "bfloat16" (which numpy lacks) leaves the f32 wire values:
    :func:`arrow_to_device` narrows them."""
    if _is_arrow(value):
        import pyarrow as pa

        if pa.types.is_string(value.type) or pa.types.is_large_string(value.type):
            text = " ".join(s for s in value.to_pylist() if s is not None)
            return np.frombuffer(text.encode(), dtype=np.uint8).copy()
        try:
            arr = value.to_numpy(zero_copy_only=True)
        except (pa.ArrowInvalid, pa.ArrowNotImplementedError):
            arr = value.to_numpy(zero_copy_only=False)
    else:
        arr = np.asarray(value)
    if metadata:
        shape = metadata.get(SHAPE_KEY)
        if shape is not None:
            arr = arr.reshape([int(s) for s in shape])
        dtype = metadata.get(DTYPE_KEY)
        if dtype is not None and dtype != "bfloat16" and str(arr.dtype) != dtype:
            arr = arr.astype(dtype)
    return arr


#: 64-bit values narrow as the JAX package's device arrays do (x64 off)
_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32}


def arrow_to_device(value: Any, metadata: dict | None, device) -> torch.Tensor:
    """An Arrow array, numpy array or tensor as a tensor on ``device``: one
    host-to-device copy, through pinned memory on the card. f64 and int64
    values become f32 and int32, the dtypes a JAX operator sees."""
    if isinstance(value, torch.Tensor):
        host = value
    else:
        arr = arrow_to_host(value, metadata)
        host = torch.from_numpy(arr if arr.flags.writeable else arr.copy())
    if metadata and metadata.get(DTYPE_KEY) == "bfloat16":
        host = host.to(torch.bfloat16)
    elif host.dtype in _NARROW:
        host = host.to(_NARROW[host.dtype])
    dev = torch.device(device)
    if dev.type == "cuda" and host.device.type == "cpu":
        pinned = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
        pinned.copy_(host)
        return pinned.to(dev, non_blocking=True)
    return host.to(dev)


def device_to_host(value: Any) -> tuple[np.ndarray, dict]:
    """A tensor (on the host already, or copied by the caller) or numpy
    array -> (flat numpy array, tensor metadata). bf16 widens to f32 and
    keeps ``dtype`` "bfloat16" for the receiver."""
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu()
        name = _DTYPE_NAMES.get(t.dtype, str(t.dtype).removeprefix("torch."))
        host = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    else:
        host = np.asarray(value)
        name = str(host.dtype)
    metadata = {SHAPE_KEY: list(host.shape), DTYPE_KEY: name}
    return np.ascontiguousarray(host).reshape(-1), metadata


def device_to_arrow(value: Any) -> tuple[Any, dict]:
    """A tensor or array -> (1-D Arrow array, tensor metadata)."""
    import pyarrow as pa

    flat, metadata = device_to_host(value)
    return pa.array(flat), metadata


def is_tensor_metadata(metadata: dict | None) -> bool:
    return bool(metadata) and SHAPE_KEY in metadata
