"""Replay source (dora_tpu/nodehub/replay.py): re-emit a recorded session
from Parquet.

The pair of ``nodehub/record.py``: every ``<input>.parquet`` under
``RECORD_DIR`` that names one of this node's declared outputs becomes that
output's stream, re-emitted in the recording's global time order and paced
by its recorded gaps, with each message's recorded metadata. Rows stream
batch by batch, so a large recording never sits in memory whole.

Env: ``RECORD_DIR`` (default ``record``), ``REPLAY_SPEED`` (1.0 real time,
2.0 twice as fast, 0 as fast as possible), ``REPLAY_LOOP`` (repeats,
default 1).
"""

from __future__ import annotations

import heapq
import json
import os
import time
from pathlib import Path

import pyarrow as pa

from dora_tpu_torch.node import Node


def _stream_file(path: Path):
    """(timestamp ns, output id, value, metadata) row by row."""
    import pyarrow.parquet as pq

    output_id = path.stem
    reader = pq.ParquetFile(path)
    has_metadata = "metadata" in reader.schema_arrow.names
    for batch in reader.iter_batches(batch_size=64):
        stamps = batch.column("timestamp_utc_ns").to_pylist()
        values = batch.column("value")
        metas = (batch.column("metadata").to_pylist() if has_metadata
                 else [None] * len(stamps))
        for i, ts in enumerate(stamps):
            yield ts, output_id, values[i].as_py(), json.loads(metas[i]) if metas[i] else {}


def stream_recording(record_dir: Path, outputs):
    """The recorded files naming one of ``outputs``, merged in time order
    (the others are skipped with a note)."""
    files = sorted(record_dir.glob("*.parquet"))
    if not files:
        raise SystemExit(f"replay: no *.parquet recordings under {record_dir}")
    selected = []
    for path in files:
        if path.stem in outputs:
            selected.append(path)
        else:
            print(f"replay: skipping {path.name} (not a declared output)", flush=True)
    if not selected:
        raise SystemExit(f"replay: none of {[f.name for f in files]} match declared "
                         f"outputs {sorted(outputs)}")
    return heapq.merge(*(_stream_file(p) for p in selected), key=lambda e: e[0])


def main() -> None:
    record_dir = Path(os.environ.get("RECORD_DIR", "record"))
    speed = float(os.environ.get("REPLAY_SPEED", "1.0"))
    loops = int(os.environ.get("REPLAY_LOOP", "1"))
    sent = 0
    with Node() as node:
        declared = set(node.config.run_config.outputs)
        for _ in range(loops):
            prev_ts = None
            for ts, output_id, value, metadata in stream_recording(record_dir, declared):
                if speed > 0 and prev_ts is not None and ts > prev_ts:
                    time.sleep((ts - prev_ts) / 1e9 / speed)
                prev_ts = ts
                node.send_output(output_id, pa.array(value), metadata)
                sent += 1
    print(f"replayed {sent} events from {record_dir}", flush=True)


if __name__ == "__main__":
    main()
