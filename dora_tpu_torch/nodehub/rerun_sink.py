"""Visualizer sink (dora_tpu/nodehub/rerun_sink.py): images, 2-D boxes and
text to a viewer, routed by input id: ``image`` (bgr8 / rgb8 / jpeg / png
from the metadata's ``encoding``, ``width``, ``height``), ``boxes2d`` (a
struct of ``bbox``, ``labels``, ``conf``, or a flat array; ``format`` xyxy
by default, or xywh) and ``text``.

With the ``rerun`` SDK installed it also logs to a Rerun recording
(``replay.rrd``; ``RERUN_SPAWN`` opens a live viewer). Always it writes a
self-contained HTML replay, ``replay.html``: the frames as embedded PNGs
(written by ``imaging.encode_png``, no PIL) with the boxes drawn on a
canvas, and a scrolling text log. Env: ``RERUN_OUT`` (output directory,
default ``rerun-out``), ``README`` (logged as a text document),
``MAX_LOG_FRAMES`` (the HTML replay's cap, default 300).
"""

from __future__ import annotations

import base64
import html
import json
import os
from pathlib import Path

import numpy as np

from dora_tpu_torch.node import Node
from dora_tpu_torch.nodehub.imaging import as_numpy, decode_image, encode_png


def _try_rerun():
    try:
        import rerun

        return rerun
    except ImportError:
        return None


def decode_boxes(value, metadata) -> dict:
    """A bbox struct {bbox, labels, conf} (or a flat array of boxes) as
    lists, in xyxy."""
    import pyarrow as pa

    fmt = str(metadata.get("format", "xyxy"))
    if isinstance(value, pa.Array) and pa.types.is_struct(value.type):
        bbox = np.asarray(value.field("bbox").flatten().to_numpy(zero_copy_only=False),
                          np.float32).reshape(-1, 4)
        labels = value.field("labels").flatten().to_pylist()
        conf = value.field("conf").flatten().to_pylist()
    else:
        bbox = as_numpy(value).astype(np.float32).reshape(-1, 4)
        labels = [""] * len(bbox)
        conf = [1.0] * len(bbox)
    if fmt == "xywh":
        x, y, w, h = bbox.T
        bbox = np.stack([x, y, x + w, y + h], axis=1)
    return {"bbox": bbox.tolist(), "labels": [str(lab) for lab in labels],
            "conf": [float(c) for c in conf]}


def png_b64(frame: np.ndarray) -> str:
    return base64.b64encode(encode_png(frame)).decode()


_HTML_TEMPLATE = """<!doctype html>
<html><head><meta charset="utf-8"><title>dora-tpu replay</title><style>
body {{ font-family: sans-serif; background: #111; color: #eee; margin: 1em; }}
canvas {{ border: 1px solid #444; }} #log {{ white-space: pre-wrap;
font-family: monospace; max-height: 16em; overflow-y: auto; }}
</style></head><body>
<h3>dora-tpu replay · {title}</h3>
<canvas id="c" width="{width}" height="{height}"></canvas>
<div><input id="s" type="range" min="0" max="{last}" value="0"
style="width:{width}px"><span id="n"></span></div>
<div id="log"></div>
<script>
const FRAMES = {frames_json};
const TEXTS = {texts_json};
const c = document.getElementById("c"), ctx = c.getContext("2d");
const s = document.getElementById("s"), n = document.getElementById("n");
function draw(i) {{
  const f = FRAMES[i]; if (!f) return;
  n.textContent = " frame " + i + " · " + f.id;
  const img = new Image();
  img.onload = () => {{
    ctx.drawImage(img, 0, 0);
    ctx.lineWidth = 2; ctx.strokeStyle = "#4f4"; ctx.fillStyle = "#4f4";
    ctx.font = "12px monospace";
    for (const [j, b] of (f.boxes ? f.boxes.bbox : []).entries()) {{
      ctx.strokeRect(b[0], b[1], b[2] - b[0], b[3] - b[1]);
      const label = (f.boxes.labels[j] || "") + " " +
        (f.boxes.conf[j] || 0).toFixed(2);
      ctx.fillText(label, b[0] + 2, b[1] + 12);
    }}
  }};
  img.src = "data:image/png;base64," + f.png;
}}
s.oninput = () => draw(+s.value);
document.getElementById("log").textContent = TEXTS.join("\\n");
draw(0);
</script></body></html>
"""


class HtmlReplay:
    """The event stream, gathered and rendered as the standalone HTML."""

    def __init__(self, max_frames: int):
        self.max_frames = max_frames
        self.frames: list[dict] = []
        self.texts: list[str] = []
        self.pending_boxes: dict | None = None
        self.size = (640, 480)

    def log_image(self, input_id: str, frame: np.ndarray) -> None:
        if len(self.frames) >= self.max_frames:
            return
        # the canvas fits the largest of the image streams
        self.size = (
            max(self.size[0], frame.shape[1]) if self.frames else frame.shape[1],
            max(self.size[1], frame.shape[0]) if self.frames else frame.shape[0],
        )
        self.frames.append({"id": input_id, "png": png_b64(frame), "boxes": self.pending_boxes})

    def log_boxes(self, boxes: dict) -> None:
        # on the latest frame, and the next ones until replaced
        self.pending_boxes = boxes
        if self.frames:
            self.frames[-1]["boxes"] = boxes

    def log_text(self, input_id: str, text: str) -> None:
        self.texts.append(f"[{input_id}] {text}")

    def write(self, path: Path, title: str) -> None:
        # "</" must not appear inside the inline <script>
        def script_safe(value) -> str:
            return json.dumps(value).replace("</", "<\\/")

        path.write_text(_HTML_TEMPLATE.format(
            title=html.escape(title), width=self.size[0], height=self.size[1],
            last=max(len(self.frames) - 1, 0), frames_json=script_safe(self.frames),
            texts_json=script_safe(self.texts)))


def main() -> None:
    out_dir = Path(os.environ.get("RERUN_OUT", "rerun-out"))
    out_dir.mkdir(parents=True, exist_ok=True)
    rr = _try_rerun()
    if rr is not None:
        rr.init("dora-tpu", spawn=bool(os.environ.get("RERUN_SPAWN")))
        rr.save(str(out_dir / "replay.rrd"))
    replay = HtmlReplay(int(os.environ.get("MAX_LOG_FRAMES", "300")))
    readme = os.environ.get("README", "")
    if readme:
        replay.log_text("README", readme)
        if rr is not None:
            rr.log("README", rr.TextDocument(readme))

    counts: dict[str, int] = {}
    with Node() as node:
        for event in node:
            if event["type"] == "STOP":
                break
            if event["type"] != "INPUT":
                continue
            input_id, value, metadata = event["id"], event["value"], event["metadata"]
            counts[input_id] = counts.get(input_id, 0) + 1
            if "image" in input_id:
                frame = decode_image(value, metadata)
                if frame is None:
                    continue
                replay.log_image(input_id, frame)
                if rr is not None:
                    rr.log(input_id, rr.Image(frame))
            elif "boxes2d" in input_id:
                boxes = decode_boxes(value, metadata)
                replay.log_boxes(boxes)
                if rr is not None:
                    rr.log(input_id, rr.Boxes2D(array=np.asarray(boxes["bbox"], np.float32),
                                                array_format=rr.Box2DFormat.XYXY,
                                                labels=boxes["labels"]))
            elif "text" in input_id:
                import pyarrow as pa

                text = (" ".join(str(v) for v in value.to_pylist())
                        if isinstance(value, pa.Array)
                        else bytes(value).decode(errors="replace"))
                replay.log_text(input_id, text)
                if rr is not None:
                    rr.log(input_id, rr.TextLog(text))
            del value, event
    replay.write(out_dir / "replay.html", title=", ".join(sorted(counts)))
    print(f"visualized {counts} -> {out_dir / 'replay.html'}")


if __name__ == "__main__":
    main()
