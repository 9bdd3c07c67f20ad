"""Camera capture node (dora_tpu/nodehub/camera.py): a frame on every
``tick`` input; env ``CAPTURE_PATH`` (device index or file),
``IMAGE_WIDTH`` / ``IMAGE_HEIGHT`` / ``ENCODING``, ``MAX_FRAMES``; it stops
itself after 10 s under ``CI``. Without OpenCV or a camera it sends a
synthetic moving pattern, or with ``SEED`` set seeded random frames, so the
dataflows run anywhere. Each frame's metadata names it: ``frame`` is its
index, from 0.
"""

from __future__ import annotations

import os
import time

import numpy as np

from dora_tpu_torch.node import Node


def _synthetic_frame(width: int, height: int, t: int) -> np.ndarray:
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    r = 0.5 + 0.5 * np.sin(xx / 17.0 + t * 0.3)
    g = 0.5 + 0.5 * np.sin(yy / 13.0 - t * 0.2)
    b = 0.5 + 0.5 * np.sin((xx + yy) / 23.0 + t * 0.1)
    return (np.stack([b, g, r], axis=-1) * 255).astype(np.uint8)


def seeded_frame(width: int, height: int, seed: int, index: int) -> np.ndarray:
    """Frame ``index`` of the seeded stream (``SEED``): uniform random bytes."""
    return np.random.default_rng([seed, index]).integers(0, 256, size=(height, width, 3),
                                                         dtype=np.uint8)


def main() -> None:
    width = int(os.environ.get("IMAGE_WIDTH", "640"))
    height = int(os.environ.get("IMAGE_HEIGHT", "480"))
    encoding = os.environ.get("ENCODING", "bgr8")
    capture_path = os.environ.get("CAPTURE_PATH", "0")
    seed = os.environ.get("SEED")

    capture = None
    if seed is None:
        try:
            import cv2

            capture = cv2.VideoCapture(
                int(capture_path) if capture_path.isdigit() else capture_path)
            if not capture.isOpened():
                capture = None
        except Exception:
            capture = None

    deadline = time.time() + 10 if os.environ.get("CI") else None
    max_frames = int(os.environ.get("MAX_FRAMES", "0"))
    frame_index = 0
    with Node() as node:
        for event in node:
            if event["type"] == "STOP":
                break
            if event["type"] != "INPUT":
                continue
            if capture is not None:
                ok, frame = capture.read()
                if not ok:
                    break
                frame = frame[:height, :width]
            elif seed is not None:
                frame = seeded_frame(width, height, int(seed), frame_index)
            else:
                frame = _synthetic_frame(width, height, frame_index)
            node.send_output(
                "image",
                np.ascontiguousarray(frame).ravel(),
                {
                    "width": frame.shape[1],
                    "height": frame.shape[0],
                    "encoding": encoding,
                    "shape": list(frame.shape),
                    "dtype": str(frame.dtype),
                    "frame": frame_index,
                },
            )
            frame_index += 1
            if deadline and time.time() > deadline:
                break
            if max_frames and frame_index >= max_frames:
                break


if __name__ == "__main__":
    main()
