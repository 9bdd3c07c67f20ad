"""Image frames for the hub's sinks (dora_tpu/nodehub/imaging.py): decode a
camera-class payload to RGB ``[H, W, 3]`` uint8, and write and read PNG with
the standard library alone.

The wire contract of a frame: a flat uint8 array with metadata ``encoding``
(bgr8 | rgb8 | jpeg | png), ``width`` and ``height``. PNG is encoded and
decoded here with ``zlib`` (the card's machine has no PIL); a JPEG payload
needs PIL and raises without it.
"""

from __future__ import annotations

import io
import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: PNG colour type by channel count (grey, grey + alpha, RGB, RGBA)
_COLOR_TYPES = {1: 0, 2: 4, 3: 2, 4: 6}


def as_numpy(value, metadata=None) -> np.ndarray:
    """An Arrow array as numpy (shaped and typed by the ``shape`` and
    ``dtype`` metadata, as ``tpu.bridge.arrow_to_host`` reads them, without
    importing torch), or raw bytes as uint8."""
    import pyarrow as pa

    if not isinstance(value, pa.Array):
        return np.asarray(memoryview(value), dtype=np.uint8)
    arr = value.to_numpy(zero_copy_only=False)
    metadata = metadata or {}
    if metadata.get("shape") is not None:
        arr = arr.reshape([int(n) for n in metadata["shape"]])
    if metadata.get("dtype") is not None and str(arr.dtype) != metadata["dtype"]:
        arr = arr.astype(metadata["dtype"])
    return arr


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(frame: np.ndarray) -> bytes:
    """An 8-bit PNG of ``frame`` ([H, W] or [H, W, C], C 1-4), each row
    with filter 0 (none)."""
    frame = np.ascontiguousarray(frame, dtype=np.uint8)
    height, width = frame.shape[:2]
    channels = 1 if frame.ndim == 2 else frame.shape[2]
    rows = np.zeros((height, 1 + width * channels), np.uint8)
    rows[:, 1:] = frame.reshape(height, -1)
    header = struct.pack(">IIBBBBB", width, height, 8, _COLOR_TYPES[channels], 0, 0, 0)
    return (PNG_SIGNATURE + _png_chunk(b"IHDR", header)
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _png_chunk(b"IEND", b""))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def decode_png(data: bytes) -> np.ndarray:
    """The pixels of an 8-bit, non-interlaced PNG, [H, W, C] uint8 (every
    row filter of the standard)."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    width, height, depth, color_type, _c, _f, interlace = header
    channels = {v: k for k, v in _COLOR_TYPES.items()}.get(color_type)
    if depth != 8 or channels is None or interlace:
        raise ValueError(f"PNG of depth {depth}, colour type {color_type}, interlace "
                         f"{interlace}: only 8-bit non-interlaced grey/RGB(A) is read")
    stride = width * channels
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, line = raw[y, 0], raw[y, 1:].astype(np.int32)
        if kind == 0:
            row = line
        elif kind == 2:
            row = line + prev
        elif kind in (1, 3, 4):
            row = line.copy()
            up = prev.astype(np.int32)
            for x in range(stride):
                left = row[x - channels] if x >= channels else 0
                if kind == 1:
                    row[x] = (row[x] + left) & 0xFF
                elif kind == 3:
                    row[x] = (row[x] + ((left + int(up[x])) >> 1)) & 0xFF
                else:
                    corner = int(up[x - channels]) if x >= channels else 0
                    row[x] = (row[x] + _paeth(int(left), int(up[x]), corner)) & 0xFF
        else:
            raise ValueError(f"PNG row filter {kind}")
        out[y] = prev = (row & 0xFF).astype(np.uint8)
    return out.reshape(height, width, channels)


def decode_image(value, metadata) -> np.ndarray | None:
    """Metadata-driven decode to RGB [H, W, 3] uint8; None when the payload
    is too small for the declared geometry."""
    encoding = str(metadata.get("encoding", "bgr8"))
    if encoding == "png":
        frame = decode_png(bytes(as_numpy(value).astype(np.uint8).reshape(-1)))
        if frame.shape[2] == 1:
            return np.repeat(frame, 3, axis=2)
        return frame[..., :3]
    if encoding == "jpeg":
        from PIL import Image  # JPEG alone needs PIL

        data = bytes(as_numpy(value).astype(np.uint8).reshape(-1))
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    width = int(metadata.get("width", 640))
    height = int(metadata.get("height", 480))
    flat = as_numpy(value, metadata).astype(np.uint8).reshape(-1)
    if flat.size < width * height * 3:
        return None
    frame = flat[: width * height * 3].reshape(height, width, 3)
    if encoding == "bgr8":
        frame = frame[..., ::-1]
    return frame
