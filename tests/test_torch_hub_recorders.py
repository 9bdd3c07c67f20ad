"""The port's recorder and replay hub nodes (dora_tpu_torch/nodehub/
imaging.py, keyboard.py, llama_recorder.py, replay.py, rerun_sink.py)
against their JAX twins on the same inputs, on the CPU.

* imaging: every encoding (bgr8, rgb8, png of either encoder, jpeg) decodes
  to the JAX twin's pixels; the port's PNG writer and reader (the standard
  library's zlib, no PIL) against PIL, every row filter.
* keyboard: ``main`` without a TTY sends the JAX twin's characters.
* llama_recorder and rerun_sink, end to end under each package's daemon
  with its own nodes: the same dataset records and ``dataset_info.json``,
  PNG pixels equal; the same HTML replay (frames, boxes, texts), its PNGs'
  pixels equal.
* replay: a Parquet recording re-emitted under each daemon gives the same
  values and metadata, in the same order.
"""

from __future__ import annotations

import base64
import importlib
import io
import json
import re
import struct
import textwrap
import zlib

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch
from PIL import Image

from dora_tpu.core.descriptor import Descriptor as JDescriptor
from dora_tpu.daemon import run_dataflow as jax_run
from dora_tpu_torch.core.descriptor import Descriptor
from dora_tpu_torch.daemon import run_dataflow as port_run
from dora_tpu_torch.nodehub import imaging

LIMIT_S = 90
SIDES = (("port", "dora_tpu_torch"), ("jax", "dora_tpu"))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _daemon_routes(monkeypatch):
    monkeypatch.setenv("DORA_P2P", "0")


def _frame(seed: int, h: int = 24, w: int = 32) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)


def _pil_png(frame: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, format="PNG")
    return buf.getvalue()


def _pixels(png: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(png)).convert("RGB"))


def _filtered_png(frame: np.ndarray, filters: list[int]) -> bytes:
    """An RGB PNG of ``frame`` whose row y uses filter ``filters[y]``."""
    h, w, c = frame.shape
    stride = w * c
    rows, prev = [], np.zeros(stride, np.int32)
    for y in range(h):
        line = frame[y].reshape(-1).astype(np.int32)
        kind = filters[y]
        left = np.concatenate([np.zeros(c, np.int32), line[:-c]])
        corner = np.concatenate([np.zeros(c, np.int32), prev[:-c]])
        if kind == 0:
            pred = np.zeros(stride, np.int32)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - corner
            pa_, pb, pc = abs(p - left), abs(p - prev), abs(p - corner)
            pred = np.where((pa_ <= pb) & (pa_ <= pc), left, np.where(pb <= pc, prev, corner))
        rows.append(bytes([kind]) + ((line - pred) & 0xFF).astype(np.uint8).tobytes())
        prev = line

    def chunk(kind: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + kind + data + struct.pack(
            ">I", zlib.crc32(kind + data) & 0xFFFFFFFF)

    return (imaging.PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


def test_png_writer_and_reader_against_pil():
    frame = _frame(1, 9, 13)
    assert np.array_equal(_pixels(imaging.encode_png(frame)), frame)
    assert np.array_equal(imaging.decode_png(_pil_png(frame)), frame)
    every_filter = _filtered_png(frame, [0, 1, 2, 3, 4, 3, 4, 1, 2])
    assert np.array_equal(_pixels(every_filter), frame)  # the fixture is a valid PNG
    assert np.array_equal(imaging.decode_png(every_filter), frame)
    grey = frame[..., 0]
    assert np.array_equal(np.asarray(Image.open(io.BytesIO(imaging.encode_png(grey)))), grey)


@pytest.mark.parametrize("encoding", ["bgr8", "rgb8", "png", "png-port", "jpeg", "short"])
def test_decode_image_equals_jax(encoding):
    from dora_tpu.nodehub import imaging as jimaging

    frame = _frame(2)
    meta = {"encoding": encoding, "width": 32, "height": 24}
    if encoding in ("bgr8", "rgb8"):
        payload = frame.reshape(-1)
    elif encoding == "short":
        meta["encoding"] = "bgr8"
        payload = frame.reshape(-1)[:100]
    elif encoding == "jpeg":
        buf = io.BytesIO()
        Image.fromarray(frame).save(buf, format="JPEG")
        payload = np.frombuffer(buf.getvalue(), np.uint8)
    else:
        meta["encoding"] = "png"
        png = imaging.encode_png(frame) if encoding == "png-port" else _pil_png(frame)
        payload = np.frombuffer(png, np.uint8)
    value = pa.array(payload)
    got, want = imaging.decode_image(value, meta), jimaging.decode_image(value, meta)
    if encoding == "short":
        assert got is None and want is None
    else:
        assert np.array_equal(got, want)


class _FakeNode:
    sent: list = []

    def __init__(self, *args, **kwargs):
        pass

    def send_output(self, output_id, data=None, metadata=None):
        type(self).sent.append((output_id, bytes(data)))

    def close(self):
        pass


def test_keyboard_sends_the_jax_twins_characters(monkeypatch):
    monkeypatch.setenv("KEYBOARD_SYNTHETIC", "héllo, wörld")
    monkeypatch.setenv("CHAR_DELAY_MS", "0")
    monkeypatch.setenv("MAX_CHARS", "9")
    monkeypatch.setattr("sys.stdin.isatty", lambda: False)
    out = {}
    for side, pkg in SIDES:
        module = importlib.import_module(f"{pkg}.nodehub.keyboard")
        monkeypatch.setattr(module, "Node", _FakeNode)
        _FakeNode.sent = []
        module.main()
        out[side] = _FakeNode.sent
    assert out["port"] == out["jax"] == [("char", c.encode()) for c in "héllo, wö"]


SOURCE = """
import time
import numpy as np
import pyarrow as pa
from {pkg}.node import Node

def frame(seed):
    return np.random.default_rng(seed).integers(0, 256, (24, 32, 3), dtype=np.uint8)

geometry = {{"width": 32, "height": 24}}
with Node() as node:
    node.send_output("image", pa.array(frame(0).reshape(-1)), dict(geometry, encoding="bgr8"))
    time.sleep(0.2)
    node.send_output("question", pa.array(["what is in the frame?"]))
    time.sleep(0.2)
    node.send_output("answer", pa.array(["noise, mostly"]))
    time.sleep(0.2)
    boxes = pa.StructArray.from_arrays(
        [pa.array([[1.0, 2.0, 10.0, 12.0], [3.0, 4.0, 5.0, 6.0]]), pa.array([["cat", "dog"]] * 2),
         pa.array([[0.9, 0.4]] * 2)], names=["bbox", "labels", "conf"])
    node.send_output("boxes", boxes[:1], {{"format": "xywh"}})
    time.sleep(0.2)
    node.send_output("image", pa.array(frame(1).reshape(-1)), dict(geometry, encoding="rgb8"))
    time.sleep(0.2)
    node.send_output("answer", pa.array(["more noise </script>"]))
    time.sleep(0.2)
"""


def _recorder_spec(pkg: str) -> dict:
    return {"nodes": [
        {"id": "source", "path": "source.py", "outputs": ["image", "question", "answer", "boxes"]},
        {"id": "recorder", "path": f"module:{pkg}.nodehub.llama_recorder",
         "inputs": {"image": "source/image", "text": "source/question",
                    "ground_truth": "source/answer"},
         "env": {"LLAMA_FACTORY_ROOT_PATH": "factory", "ENTRY_NAME": "demo"}},
        {"id": "viz", "path": f"module:{pkg}.nodehub.rerun_sink",
         "inputs": {"image": "source/image", "text": "source/answer",
                    "boxes2d": "source/boxes"},
         "env": {"RERUN_OUT": "rerun-out", "README": "a test </script> readme"}},
    ]}


def _html_replay(path) -> dict:
    text = path.read_text()
    frames = json.loads(re.search(r"const FRAMES = (.*);\n", text).group(1).replace("<\\/", "</"))
    texts = json.loads(re.search(r"const TEXTS = (.*);\n", text).group(1).replace("<\\/", "</"))
    size = re.search(r'<canvas id="c" width="(\d+)" height="(\d+)">', text).groups()
    pixels = [_pixels(base64.b64decode(f.pop("png"))) for f in frames]
    return {"frames": frames, "texts": texts, "size": size, "pixels": pixels,
            "title": re.search(r"<h3>dora-tpu replay · (.*)</h3>", text).group(1)}


def test_recorder_and_rerun_sink_equal_jax(tmp_path):
    out = {}
    for side, pkg in SIDES:
        work = tmp_path / side
        work.mkdir()
        (work / "source.py").write_text(textwrap.dedent(SOURCE.format(pkg=pkg)))
        spec = _recorder_spec(pkg)
        run = port_run if side == "port" else jax_run
        desc = (Descriptor if side == "port" else JDescriptor).parse(spec)
        result = run(desc, working_dir=work, timeout_s=LIMIT_S)
        assert result.is_ok(), (side, result.errors())
        data = work / "factory" / "data"
        records = [json.loads(line) for line in (data / "demo.json").read_text().splitlines()]
        pngs = {p: _pixels((data / p).read_bytes()) for r in records for p in r["images"]}
        out[side] = {"records": records, "info": json.loads((data / "dataset_info.json")
                                                            .read_text()),
                     "pngs": pngs, "html": _html_replay(work / "rerun-out" / "replay.html")}
    port, jax = out["port"], out["jax"]
    assert port["records"] == jax["records"] and len(port["records"]) == 2
    assert port["records"][0]["messages"][0]["content"] == "<image>what is in the frame?"
    assert port["info"] == jax["info"]
    assert port["pngs"].keys() == jax["pngs"].keys()
    assert all(np.array_equal(port["pngs"][k], jax["pngs"][k]) for k in port["pngs"])
    frame0 = _frame(0)[..., ::-1]
    assert np.array_equal(port["pngs"]["demo/image-0.png"], frame0)
    ph, jh = port["html"], jax["html"]
    assert (ph["frames"], ph["texts"], ph["size"], ph["title"]) == \
        (jh["frames"], jh["texts"], jh["size"], jh["title"])
    assert len(ph["pixels"]) == 2 and all(np.array_equal(a, b)
                                          for a, b in zip(ph["pixels"], jh["pixels"]))
    assert ph["frames"][1]["boxes"]["bbox"] == [[1.0, 2.0, 11.0, 14.0]]


REPLAY_SINK = """
import json
from {pkg}.node import Node

got = []
with Node() as node:
    for event in node:
        if event["type"] == "INPUT":
            got.append([event["id"], event["value"].to_pylist(), event["metadata"]])
json.dump(got, open("got.json", "w"))
"""


def test_replay_equals_jax(tmp_path):
    record = tmp_path / "recording"
    record.mkdir()
    for name, rows in (("image", [(10, [1, 2, 3], {"shape": [3]}), (30, [4, 5, 6], {})]),
                       ("text", [(20, ["hello"], {"k": 1}), (25, ["world"], None)]),
                       ("other", [(5, [0], {})])):
        pq.write_table(pa.table({
            "timestamp_utc_ns": pa.array([r[0] for r in rows], pa.int64()),
            "value": [r[1] for r in rows],
            "metadata": [json.dumps(r[2]) if r[2] is not None else None for r in rows]}),
            record / f"{name}.parquet")
    out = {}
    for side, pkg in SIDES:
        work = tmp_path / side
        work.mkdir()
        (work / "sink.py").write_text(textwrap.dedent(REPLAY_SINK.format(pkg=pkg)))
        spec = {"nodes": [
            {"id": "replay", "path": f"module:{pkg}.nodehub.replay", "outputs": ["image", "text"],
             "env": {"RECORD_DIR": str(record), "REPLAY_SPEED": "0", "REPLAY_LOOP": "2"}},
            {"id": "sink", "path": "sink.py",
             "inputs": {"image": {"source": "replay/image", "queue_size": 64},
                        "text": {"source": "replay/text", "queue_size": 64}}},
        ]}
        run = port_run if side == "port" else jax_run
        result = run((Descriptor if side == "port" else JDescriptor).parse(spec),
                     working_dir=work, timeout_s=LIMIT_S)
        assert result.is_ok(), (side, result.errors())
        out[side] = json.loads((work / "got.json").read_text())
    assert out["port"] == out["jax"]
    assert [(i, v) for i, v, _m in out["port"]] == [
        ("image", [1, 2, 3]), ("text", ["hello"]), ("text", ["world"]), ("image", [4, 5, 6])] * 2
