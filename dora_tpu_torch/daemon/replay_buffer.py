"""Daemon-side replay buffer (dora_tpu/daemon/replay_buffer.py): un-acked
in-flight inputs of a restartable node, redelivered on respawn.

A poll is the ack seam, with a lag: a node's event stream polls
``NextEvent`` for batch *k+1* once it has *queued* batch *k*, not consumed
it. Its local queue holds ``EventStream.DEFAULT_MAX_QUEUE`` (2) events and
its loop one more, so at most three events outside the batch being queued
are unconsumed, and they lie in at most the ``ACK_LAG`` batches before it.
The events loop ``remember()``s each delivered batch and ``ack()``s on
each poll, forgetting the batches older than that; when the node dies the
daemon ``drain()``s the buffer back to the FRONT of the node's event queue
before respawning, so the new incarnation sees every unconsumed input
again, in order: at-least-once delivery (consumers dedup by request id, as
``nodehub/llm_server`` does). The JAX package's buffer forgets every batch
on the next poll, and so can lose the inputs its node had queued but not
consumed.

The in-memory window is bounded: beyond ``max_entries`` the oldest
entries spill to a Parquet file with the ``nodehub/record.py`` schema
(timestamp / trace / value / metadata, zstd) under the dataflow's
working dir — crash forensics stay readable with the standard replay
tooling even when the spill is never redelivered. Spilled rows hold the
pre-framed wire image, so redelivery rebuilds :class:`QueueEntry`
objects without re-encoding.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Any

from dora_tpu_torch.daemon.queues import QueueEntry

logger = logging.getLogger(__name__)

#: In-memory un-acked window per node. A node's NextEvent batch is at
#: most MAX_BATCH=64 entries; several batches can be outstanding only
#: briefly, so 256 covers the normal case without spilling.
DEFAULT_MAX_ENTRIES = 256

#: batches kept un-acked before the newest (see the module docstring)
ACK_LAG = 3

#: Hard cap on spilled rows — the buffer is bounded end to end; beyond
#: this, the oldest spilled rows are forgotten (counted, not silent).
MAX_SPILL_ROWS = 4096


class ReplayBuffer:
    """Un-acked delivered inputs of one restartable node."""

    def __init__(self, node_id: str, spill_dir: str | Path | None = None,
                 max_entries: int = DEFAULT_MAX_ENTRIES):
        self.node_id = node_id
        self.max_entries = max_entries
        self.spill_dir = Path(spill_dir) if spill_dir else None
        #: delivered batches (their input entries), oldest first
        self._batches: list[list[QueueEntry]] = []
        self._spilled: list[dict[str, Any]] = []
        self._writer = None
        self._spill_path: Path | None = None
        #: entries dropped past the spill cap (observability, not silence)
        self.overflow_dropped = 0
        #: total entries redelivered across respawns
        self.replayed_total = 0

    def __len__(self) -> int:
        return sum(map(len, self._batches)) + len(self._spilled)

    # -- feed (events loop) --------------------------------------------------

    def remember(self, entries: list[QueueEntry]) -> None:
        """Record a just-delivered batch as un-acked (Stop and Closed
        markers are regenerated, not replayed)."""
        self._batches.append([e for e in entries if e.input_id is not None])
        while sum(map(len, self._batches)) > self.max_entries:
            oldest = self._batches[0]
            self._spill(oldest.pop(0))
            if not oldest:
                self._batches.pop(0)

    def ack(self) -> None:
        """The node polled again: the batches older than the last ACK_LAG
        were consumed (the spilled rows, older still, with them)."""
        if len(self._batches) > ACK_LAG:
            del self._batches[:-ACK_LAG]
            self._spilled.clear()

    # -- spill (Parquet, record.py schema) -----------------------------------

    def _spill(self, entry: QueueEntry) -> None:
        if len(self._spilled) >= MAX_SPILL_ROWS:
            self._spilled.pop(0)
            self.overflow_dropped += 1
        wire = entry.wire
        if wire is None and entry.event is not None:
            from dora_tpu_torch.message.serde import encode

            wire = encode(entry.event)
        row = {
            "timestamp_utc_ns": int(entry.send_ns or 0),
            "trace": "",
            "value": wire,  # pre-framed wire image (see module doc)
            "metadata": json.dumps(
                {"input_id": entry.input_id, "drop_token": entry.drop_token}
            ),
        }
        self._spilled.append(row)
        if self.spill_dir is not None:
            try:
                self._write_spill_row(row)
            except Exception as e:  # pragma: no cover - disk-full etc.
                logger.warning("replay spill write failed for %s: %s",
                               self.node_id, e)

    def _write_spill_row(self, row: dict[str, Any]) -> None:
        import pyarrow as pa
        import pyarrow.parquet as pq

        if self._writer is None:
            self.spill_dir.mkdir(parents=True, exist_ok=True)
            self._spill_path = self.spill_dir / f"replay_{self.node_id}.parquet"
            schema = pa.schema(
                [
                    pa.field("timestamp_utc_ns", pa.int64()),
                    pa.field("trace", pa.string()),
                    pa.field("value", pa.binary()),
                    pa.field("metadata", pa.string()),
                ]
            )
            self._writer = pq.ParquetWriter(
                self._spill_path, schema, compression="zstd"
            )
        self._writer.write_table(
            pa.table(
                {
                    "timestamp_utc_ns": [row["timestamp_utc_ns"]],
                    "trace": [row["trace"]],
                    "value": [row["value"]],
                    "metadata": [row["metadata"]],
                },
                schema=self._writer.schema,
            )
        )

    # -- drain (respawn path) ------------------------------------------------

    def drain(self) -> list[QueueEntry]:
        """All un-acked entries in original delivery order (spilled rows
        first — they are the oldest), cleared from the buffer."""
        out: list[QueueEntry] = []
        for row in self._spilled:
            meta = json.loads(row["metadata"]) if row["metadata"] else {}
            out.append(
                QueueEntry(
                    event=None,
                    input_id=meta.get("input_id"),
                    drop_token=meta.get("drop_token"),
                    wire=row["value"],
                    send_ns=row["timestamp_utc_ns"],
                )
            )
        for batch in self._batches:
            out.extend(batch)
        self._spilled = []
        self._batches = []
        self.replayed_total += len(out)
        return out

    def close(self) -> None:
        if self._writer is not None:
            try:
                self._writer.close()
            except Exception:
                pass
            self._writer = None
