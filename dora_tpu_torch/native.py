"""ctypes bindings to the shared-memory layer (``csrc/shmem.cpp``).

The port's copy of dora_tpu/native.py: named regions (the zero-copy payload
path for outputs and inputs of ``ZERO_COPY_THRESHOLD`` bytes or more) and
both sides of the request-reply channel a daemon offers as
``ShmemCommunication`` (the daemon creates and serves it, the node opens it). ``csrc/shmem.cpp`` is a copy of the JAX
package's ``native/shmem.cpp``, so both sides map the same layout.

The library is built with ``g++`` at first use into ``dora_tpu_torch/_build/``,
named after the hash of its source; the build publishes atomically (a
temporary file renamed into place), so node processes starting together
never load a half-written library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
SRC = _PKG / "csrc" / "shmem.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libshmem-{digest}.so"


def build() -> Path:
    """The shared library, compiled with g++ unless this source's build is
    already there; raises with the compiler's output on failure."""
    lib = library_path()
    if lib.exists():
        return lib
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) to build the shared-memory library")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    try:
        res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SRC), "-lrt", "-pthread"],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"building {SRC.name} failed:\n{res.stderr}")
        os.replace(tmp, lib)
    finally:
        tmp.unlink(missing_ok=True)
    return lib


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        P, U64, U32, I64, I = (ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint32,
                               ctypes.c_int64, ctypes.c_int)
        for name, res, args in (
            ("dtp_region_create", P, [ctypes.c_char_p, U64]),
            ("dtp_region_open", P, [ctypes.c_char_p]),
            ("dtp_region_ptr", P, [P]),
            ("dtp_region_size", U64, [P]),
            ("dtp_region_close", None, [P, I]),
            ("dtp_region_unlink", I, [ctypes.c_char_p]),
            ("dtp_channel_create", P, [ctypes.c_char_p, U32]),
            ("dtp_channel_open", P, [ctypes.c_char_p]),
            ("dtp_channel_capacity", U32, [P]),
            ("dtp_channel_send", I, [P, ctypes.c_char_p, U64, I]),
            ("dtp_channel_try_send", I, [P, ctypes.c_char_p, U64, I]),
            ("dtp_channel_recv", I64, [P, P, U64, I64, I]),
            ("dtp_channel_disconnect", None, [P]),
            ("dtp_channel_close", None, [P, I]),
        ):
            fn = getattr(lib, name)
            fn.restype = res
            fn.argtypes = args
        _lib = lib
        return lib


class ShmemError(RuntimeError):
    pass


class Disconnected(ShmemError):
    pass


class ShmemRegion:
    """A named shared-memory region, readable and writable without a copy.

    The region implements the buffer protocol with export counting: take
    views as ``memoryview(region)``; ``close()`` then refuses to unmap while
    such views are alive (unmapping under a live view is a segfault, not an
    exception) unless forced."""

    def __init__(self, handle: int, name: str, owner: bool):
        self._h = handle
        self.name = name
        self.owner = owner
        lib = _load()
        self.size = lib.dtp_region_size(handle)
        self._carray = (ctypes.c_ubyte * self.size).from_address(lib.dtp_region_ptr(handle))
        self._exports = 0

    def __buffer__(self, flags) -> memoryview:
        if not self._h:
            raise ShmemError(f"shmem region {self.name!r} is closed")
        self._exports += 1
        return memoryview(self._carray).cast("B")

    def __release_buffer__(self, view: memoryview) -> None:
        self._exports -= 1
        view.release()

    def __len__(self) -> int:
        return self.size

    @classmethod
    def create(cls, name: str, size: int) -> "ShmemRegion":
        h = _load().dtp_region_create(name.encode(), size)
        if not h:
            raise ShmemError(f"failed to create shmem region {name!r} ({size} B)")
        return cls(h, name, owner=True)

    @classmethod
    def open(cls, name: str) -> "ShmemRegion":
        h = _load().dtp_region_open(name.encode())
        if not h:
            raise ShmemError(f"failed to open shmem region {name!r}")
        return cls(h, name, owner=False)

    def close(self, unlink: bool | None = None, force: bool = False) -> None:
        """Unmap (and unlink, if the owner, or as ``unlink`` says). Refuses
        while views are alive, unless ``force`` (the caller guarantees no
        view is touched again)."""
        if not self._h:
            return
        if self._exports > 0 and not force:
            import gc

            gc.collect()  # views may be unreachable but not yet collected
            if self._exports > 0:
                raise BufferError(
                    f"shmem region {self.name!r} still has {self._exports} live view(s); "
                    f"drop them before close() (or pass force=True)")
        self._carray = None
        _load().dtp_region_close(self._h, 1 if (self.owner if unlink is None else unlink) else 0)
        self._h = 0


class ShmemChannel:
    """A synchronous request-reply channel inside one shared-memory segment:
    the daemon is the server (``create``), the node the client (``open``);
    requests and replies alternate, sharing the payload area."""

    def __init__(self, handle: int, name: str, is_server: bool = False):
        self._h = handle
        self.name = name
        self.is_server = is_server
        self._lib = _load()
        self.capacity = self._lib.dtp_channel_capacity(handle)
        self._recv_buf = ctypes.create_string_buffer(self.capacity)

    @classmethod
    def create(cls, name: str, capacity: int = 1 << 20) -> "ShmemChannel":
        h = _load().dtp_channel_create(name.encode(), capacity)
        if not h:
            raise ShmemError(f"failed to create shmem channel {name!r}")
        return cls(h, name, is_server=True)

    @classmethod
    def open(cls, name: str) -> "ShmemChannel":
        h = _load().dtp_channel_open(name.encode())
        if not h:
            raise ShmemError(f"failed to open shmem channel {name!r}")
        return cls(h, name)

    def send(self, data: bytes) -> None:
        if not self._h:
            raise ShmemError(f"channel {self.name} is closed")
        self._check_send_rc(self._lib.dtp_channel_send(self._h, data, len(data),
                                                       int(self.is_server)), len(data))

    def try_send(self, data: bytes) -> bool:
        """Send without blocking; False while the previous message in this
        direction is still unconsumed."""
        if not self._h:
            raise ShmemError(f"channel {self.name} is closed")
        rc = self._lib.dtp_channel_try_send(self._h, data, len(data), int(self.is_server))
        if rc == -1:
            return False
        self._check_send_rc(rc, len(data))
        return True

    def _check_send_rc(self, rc: int, size: int) -> None:
        if rc == -2:
            raise Disconnected(f"channel {self.name} disconnected")
        if rc == -3:
            raise ShmemError(f"message of {size} B exceeds channel capacity {self.capacity}")
        if rc != 0:
            raise ShmemError(f"send failed with {rc}")

    def recv(self, timeout: float | None = None) -> bytes | None:
        """One message; None on timeout; raises Disconnected."""
        if not self._h:
            raise ShmemError(f"channel {self.name} is closed")
        timeout_ms = -1 if timeout is None else max(0, int(timeout * 1000))
        n = self._lib.dtp_channel_recv(self._h, self._recv_buf, self.capacity, timeout_ms,
                                       int(self.is_server))
        if n >= 0:
            return ctypes.string_at(self._recv_buf, n)
        if n == -1:
            return None
        if n == -2:
            raise Disconnected(f"channel {self.name} disconnected")
        raise ShmemError(f"recv failed with {n}")

    def disconnect(self) -> None:
        if self._h:
            self._lib.dtp_channel_disconnect(self._h)

    def close(self, unlink: bool | None = None) -> None:
        """Unmap (and unlink: the server's default)."""
        if self._h:
            self._lib.dtp_channel_close(
                self._h, 1 if (self.is_server if unlink is None else unlink) else 0)
            self._h = 0
            self._recv_buf = None



def unlink_region(name: str) -> None:
    """Remove a region's (or channel's) name; its mappings stay valid. A
    name that does not exist is no error."""
    _load().dtp_region_unlink(name.encode())
