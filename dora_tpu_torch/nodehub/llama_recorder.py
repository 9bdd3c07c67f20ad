"""Training-pair recorder (dora_tpu/nodehub/llama_recorder.py): frames, a
question and an answer into a LLaMA-Factory sharegpt dataset.

Every ``*image*`` input's latest frame is kept, ``text`` updates the
question, and each ``ground_truth`` writes the frames as PNGs (the standard
library's encoder, ``imaging.encode_png``) and appends one sharegpt record,
``{"messages": [user "<image>" * N + question, assistant answer],
"images": [...]}``, as a JSON line to ``<entry>.json``; ``dataset_info.json``
registers the dataset once its first pair exists.

Env: ``LLAMA_FACTORY_ROOT_PATH`` (required: entries land under
``<root>/data``), ``ENTRY_NAME`` (default ``dora_demo``, suffixed when
taken), ``DEFAULT_QUESTION``.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np

from dora_tpu_torch.node import Node
from dora_tpu_torch.nodehub.imaging import decode_image, encode_png

DATASET_TAGS = {
    "role_tag": "role",
    "content_tag": "content",
    "user_tag": "user",
    "assistant_tag": "assistant",
}


def update_dataset_info(info_path: Path, entry_name: str) -> None:
    """Register the dataset in ``dataset_info.json``, keeping its other
    entries."""
    info = {}
    if info_path.exists():
        try:
            info = json.loads(info_path.read_text())
        except json.JSONDecodeError:
            info = {}
    info[entry_name] = {
        "file_name": entry_name + ".json",
        "formatting": "sharegpt",
        "columns": {"messages": "messages", "images": "images"},
        "tags": DATASET_TAGS,
    }
    info_path.write_text(json.dumps(info, indent=4, ensure_ascii=False))


def unique_entry_name(data_dir: Path, entry_name: str) -> str:
    if not (data_dir / f"{entry_name}.json").exists():
        return entry_name
    i = 1
    while (data_dir / f"{entry_name}_{i}.json").exists():
        i += 1
    return f"{entry_name}_{i}"


def save_pair(data_dir: Path, entry_name: str, frames: dict[str, np.ndarray], question: str,
              answer: str) -> dict:
    """Write the PNGs and append one sharegpt record; returns the record."""
    image_dir = data_dir / entry_name
    image_dir.mkdir(parents=True, exist_ok=True)
    pair_index = len(list(image_dir.iterdir()))
    image_paths = []
    for event_id, frame in frames.items():
        rel = f"{entry_name}/{event_id.replace('/', '_')}-{pair_index}.png"
        (data_dir / rel).write_bytes(encode_png(frame))
        image_paths.append(rel)
    record = {
        "messages": [
            {"content": "<image>" * len(frames) + question, "role": "user"},
            {"content": answer, "role": "assistant"},
        ],
        "images": image_paths,
    }
    with open(data_dir / f"{entry_name}.json", "a", encoding="utf-8") as f:
        f.write(json.dumps(record, ensure_ascii=False) + "\n")
    return record


def _text_of(value) -> str:
    import pyarrow as pa

    if isinstance(value, pa.Array):
        items = value.to_pylist()
        return str(items[0]) if items else ""
    return bytes(value).decode(errors="replace")


def main() -> None:
    root = os.environ.get("LLAMA_FACTORY_ROOT_PATH")
    assert root, ("LLAMA_FACTORY_ROOT_PATH is not set; point it at the LLaMA-Factory checkout "
                  "(or any directory) to receive the dataset")
    data_dir = Path(root) / "data"
    data_dir.mkdir(parents=True, exist_ok=True)
    entry_name = unique_entry_name(data_dir, os.environ.get("ENTRY_NAME", "dora_demo"))
    question = os.environ.get("DEFAULT_QUESTION", "Describe this image")
    frames: dict[str, np.ndarray] = {}
    pairs = 0
    with Node() as node:
        for event in node:
            if event["type"] == "STOP":
                break
            if event["type"] != "INPUT":
                continue
            input_id = event["id"]
            if "image" in input_id:
                frame = decode_image(event["value"], event["metadata"])
                if frame is not None:
                    frames[input_id] = np.array(frame)  # not a view of the sender's region
            elif input_id == "text":
                text = _text_of(event["value"])
                if text:
                    question = text
            elif input_id == "ground_truth":
                if not frames:
                    continue
                save_pair(data_dir, entry_name, frames, question, _text_of(event["value"]))
                pairs += 1
                if pairs == 1:
                    # registered once data exists: an aborted run leaves no
                    # entry pointing at a missing file
                    update_dataset_info(data_dir / "dataset_info.json", entry_name)
    print(f"recorded {pairs} pairs -> {data_dir / (entry_name + '.json')}")


if __name__ == "__main__":
    main()
