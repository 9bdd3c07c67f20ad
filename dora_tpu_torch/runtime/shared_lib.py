"""A shared-library operator in the port's runtime (dora_tpu/runtime/shared_lib.py):
load a library of the C operator ABI (``native/dora_operator_api.h``:
``dora_init_operator``, ``dora_on_event``, ``dora_drop_operator``) with
ctypes, turn the node's events into ABI calls and the operator's
``send_output`` callback into the node's outputs.

An input reaches the operator as bytes: raw payloads as they came, Arrow
arrays as their IPC stream, with ``encoding`` saying which; what it sends
with encoding ``arrow-ipc`` is published as the Arrow array, anything else
as raw bytes. A status other than CONTINUE stops the operator. Shared
libraries do not hot-reload.
"""

from __future__ import annotations

import ctypes
import logging
from pathlib import Path

from dora_tpu_torch.core.validate import adjust_shared_library_path
from dora_tpu_torch.tpu.api import DoraStatus

logger = logging.getLogger(__name__)

#: DoraOperatorEventType of the header
_EVENT_INPUT = 0
_EVENT_INPUT_CLOSED = 1
_EVENT_STOP = 2

_SEND_FN = ctypes.CFUNCTYPE(
    ctypes.c_int,
    ctypes.c_void_p,  # context
    ctypes.c_char_p,  # output id
    ctypes.POINTER(ctypes.c_ubyte),  # data
    ctypes.c_size_t,  # len
    ctypes.c_char_p,  # encoding
)


class _Event(ctypes.Structure):
    """DoraOperatorEvent."""

    _fields_ = [
        ("type", ctypes.c_int),
        ("id", ctypes.c_char_p),
        ("data", ctypes.POINTER(ctypes.c_ubyte)),
        ("data_len", ctypes.c_size_t),
        ("encoding", ctypes.c_char_p),
    ]


class _SendOutput(ctypes.Structure):
    """DoraOperatorSendOutput."""

    _fields_ = [("context", ctypes.c_void_p), ("send", _SEND_FN)]


class SharedLibOperatorHost:
    """One C-ABI operator instance; ``node`` (set before the first event)
    publishes its outputs."""

    def __init__(self, definition, working_dir: Path, node=None):
        self.definition = definition
        self.node = node
        self.stopped = False
        path = Path(definition.source.source)
        if not path.is_absolute():
            path = working_dir / path
        self._lib = ctypes.CDLL(str(adjust_shared_library_path(path)))
        self._lib.dora_init_operator.restype = ctypes.c_void_p
        self._lib.dora_on_event.restype = ctypes.c_int
        self._lib.dora_on_event.argtypes = [ctypes.c_void_p, ctypes.POINTER(_Event),
                                            ctypes.POINTER(_SendOutput)]
        self._lib.dora_drop_operator.argtypes = [ctypes.c_void_p]
        self._state = self._lib.dora_init_operator()
        op_id = str(definition.id)

        def send(_ctx, output_id, data, data_len, encoding) -> int:
            try:
                payload = (bytes(ctypes.cast(data, ctypes.POINTER(ctypes.c_ubyte * data_len))
                                 .contents) if data_len else b"")
                if (encoding or b"raw").decode() == "arrow-ipc":
                    from dora_tpu_torch.node.arrow import ipc_deserialize

                    value = ipc_deserialize(payload)
                else:
                    value = payload
                self.node.send_output(f"{op_id}/{output_id.decode()}", value)
                return 0
            except Exception:
                logger.exception("shared-library operator send_output failed")
                return 1

        # the callback lives as long as the operator
        self._send_cb = _SEND_FN(send)
        self._send_struct = _SendOutput(context=None, send=self._send_cb)

    def on_event(self, event: dict) -> DoraStatus:
        if self.stopped:
            return DoraStatus.STOP
        kind = event["type"]
        if kind == "INPUT":
            payload, encoding = self._encode_value(event)
            data_ptr = None
            if payload:
                buf = (ctypes.c_ubyte * len(payload)).from_buffer_copy(payload)
                self._buf = buf  # alive until the call returns
                data_ptr = ctypes.cast(buf, ctypes.POINTER(ctypes.c_ubyte))
            c_event = _Event(type=_EVENT_INPUT, id=(event["id"] or "").encode(), data=data_ptr,
                             data_len=len(payload) if payload else 0, encoding=encoding)
        elif kind == "INPUT_CLOSED":
            c_event = _Event(type=_EVENT_INPUT_CLOSED, id=(event["id"] or "").encode())
        else:
            c_event = _Event(type=_EVENT_STOP)
        status = DoraStatus(self._lib.dora_on_event(self._state, ctypes.byref(c_event),
                                                    ctypes.byref(self._send_struct)))
        if status != DoraStatus.CONTINUE:
            self.stopped = True
        return status

    @staticmethod
    def _encode_value(event: dict):
        value = event.get("value")
        if value is None:
            return None, b"raw"
        if isinstance(value, (bytes, bytearray, memoryview)):
            return bytes(value), b"raw"
        from dora_tpu_torch.node.arrow import ipc_serialize

        return ipc_serialize(value), b"arrow-ipc"

    def close(self) -> None:
        if self._state:
            try:
                self._lib.dora_drop_operator(self._state)
            except Exception:
                pass
            self._state = None
