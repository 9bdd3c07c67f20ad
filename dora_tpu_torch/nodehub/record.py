"""Recorder node (dora_tpu/nodehub/record.py): every input stream to a
Parquet file of its own, with the receive time (UTC ns), the trace id from
the message's OpenTelemetry context, the value and the metadata as JSON.
"""

from __future__ import annotations

import os
import time
from pathlib import Path

import pyarrow as pa
import pyarrow.parquet as pq

from dora_tpu_torch.node import Node
from dora_tpu_torch.telemetry import parse_otel_context


def main() -> None:
    out_dir = Path(os.environ.get("RECORD_DIR", "record"))
    out_dir.mkdir(parents=True, exist_ok=True)
    writers: dict[str, pq.ParquetWriter] = {}
    counts: dict[str, int] = {}

    # A daemon grace-kill is SIGTERM; turn it into SystemExit so the
    # finally below runs and the Parquet footers land on disk.
    import signal

    def _term(signum, frame):
        raise SystemExit(0)

    try:
        signal.signal(signal.SIGTERM, _term)
    except (ValueError, OSError):
        pass  # not the main thread

    # Writers close in a finally: a recording that dies mid-dataflow
    # (upstream failure, grace kill, unhandled error) must still leave
    # valid Parquet files with every row received so far — a truncated
    # file without the footer is unreadable and loses the whole run.
    try:
        with Node() as node:
            for event in node:
                if event["type"] == "STOP":
                    break
                if event["type"] != "INPUT":
                    continue
                input_id = event["id"]
                value = event["value"]
                if not isinstance(value, pa.Array):
                    value = pa.array(
                        [bytes(value) if value is not None else b""]
                    )
                otel = parse_otel_context(
                    str(event["metadata"].get("open_telemetry_context", ""))
                )
                # Metadata rides along as JSON so a replay can re-attach
                # it (tensor shape/dtype are load-bearing for consumers).
                import json

                metadata_json = json.dumps(
                    {k: v for k, v in event["metadata"].items()
                     if isinstance(v, (str, int, float, bool, list))}
                )
                batch = pa.record_batch(
                    [
                        pa.array([time.time_ns()], pa.int64()),
                        pa.array([otel.get("traceparent", "")]),
                        pa.array([pa.scalar(value.to_pylist())]),
                        pa.array([metadata_json]),
                    ],
                    names=["timestamp_utc_ns", "trace", "value", "metadata"],
                )
                writer = writers.get(input_id)
                if writer is None:
                    path = out_dir / f"{input_id.replace('/', '_')}.parquet"
                    writer = pq.ParquetWriter(
                        path, batch.schema, compression="zstd"
                    )
                    writers[input_id] = writer
                writer.write_batch(batch)
                counts[input_id] = counts.get(input_id, 0) + 1
    finally:
        for writer in writers.values():
            try:
                writer.close()
            except Exception:
                pass
    print(f"recorded {counts}")


if __name__ == "__main__":
    main()
