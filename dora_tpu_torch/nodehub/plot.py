"""Plot / overlay sink node (dora_tpu/nodehub/plot.py): draws the boxes onto
the frames and shows them. Without a display (or without OpenCV) it writes
the annotated frames to ``PLOT_OUTPUT_DIR`` (or only counts them), so CI and
benchmarks use the same graph as a workstation.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from dora_tpu_torch.node import Node
from dora_tpu_torch.tpu.bridge import arrow_to_host


def main() -> None:
    out_dir = os.environ.get("PLOT_OUTPUT_DIR")
    max_frames = int(os.environ.get("MAX_FRAMES", "0"))
    try:
        import cv2
    except Exception:
        cv2 = None

    frame = None
    meta = {}
    boxes = None
    shown = 0

    with Node() as node:
        for event in node:
            if event["type"] == "STOP":
                break
            if event["type"] != "INPUT":
                continue
            if event["id"].endswith("image"):
                meta = event["metadata"]
                frame = arrow_to_host(event["value"], meta)
                if "shape" in meta:
                    frame = frame.reshape([int(s) for s in meta["shape"]])
            elif event["id"].endswith("boxes") or event["id"] == "bbox":
                boxes = arrow_to_host(event["value"], event["metadata"])
            if frame is None:
                continue
            canvas = np.array(frame)
            if boxes is not None and cv2 is not None and boxes.ndim == 2:
                for cx, cy, w, h in boxes[:, :4]:
                    p1 = (int(cx - w / 2), int(cy - h / 2))
                    p2 = (int(cx + w / 2), int(cy + h / 2))
                    cv2.rectangle(canvas, p1, p2, (0, 255, 0), 2)
            shown += 1
            if out_dir and cv2 is not None:
                Path(out_dir).mkdir(parents=True, exist_ok=True)
                cv2.imwrite(str(Path(out_dir) / f"frame_{shown:05d}.jpg"), canvas)
            elif cv2 is not None and os.environ.get("DISPLAY"):
                cv2.imshow("dora-tpu", canvas)
                cv2.waitKey(1)
            if max_frames and shown >= max_frames:
                break
    print(f"plotted {shown} frames")


if __name__ == "__main__":
    main()
