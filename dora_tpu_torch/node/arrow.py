"""Arrow payloads of the node wire (dora_tpu/node/arrow.py): one array as a
standard Arrow IPC stream, written straight into a shared-memory region
when large and read back without a copy. Imported by the node's data plane
only when a payload is Arrow, so pyarrow is needed only then."""

from __future__ import annotations

from typing import Any

import pyarrow as pa

#: field name of the one column a bare array travels in
_FIELD = "data"

#: room for the schema message and the framing around the batch message
_IPC_OVERHEAD = 1024


def to_arrow(data: Any) -> pa.Array:
    """User data as an Arrow array (numpy arrays without a copy)."""
    if isinstance(data, pa.Array):
        return data
    if isinstance(data, pa.ChunkedArray):
        return data.combine_chunks()
    import numpy as np

    if isinstance(data, np.ndarray) and data.ndim != 1:
        data = data.ravel()
    return pa.array(data)


def _as_batch(arr: pa.Array) -> pa.RecordBatch:
    return pa.record_batch([arr], names=[_FIELD])


def ipc_max_size(arr: pa.Array) -> int:
    """Upper bound on the IPC stream size of one array."""
    return pa.ipc.get_record_batch_size(_as_batch(arr)) + _IPC_OVERHEAD


def ipc_serialize(arr: pa.Array) -> bytes:
    sink = pa.BufferOutputStream()
    batch = _as_batch(arr)
    with pa.ipc.new_stream(sink, batch.schema) as writer:
        writer.write_batch(batch)
    return sink.getvalue().to_pybytes()


def ipc_serialize_into(arr: pa.Array, buf: memoryview) -> int:
    """Serialize into a writable buffer (a mapped region); returns the bytes
    written."""
    batch = _as_batch(arr)
    sink = pa.FixedSizeBufferWriter(pa.py_buffer(buf))
    with pa.ipc.new_stream(sink, batch.schema) as writer:
        writer.write_batch(batch)
    return sink.tell()


def ipc_deserialize(buf: Any) -> pa.Array:
    """One array from an IPC stream (bytes or a memoryview), without a copy:
    the array keeps the buffer alive."""
    table = pa.ipc.open_stream(pa.py_buffer(buf)).read_all()
    column = table.column(0)
    return column.chunk(0) if column.num_chunks == 1 else column.combine_chunks()
