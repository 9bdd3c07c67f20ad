"""Test-fixture node: assert that every input equals a literal pyarrow value
(dora_tpu/nodehub/pyarrow_assert.py).

Exits non-zero, failing the dataflow, when an input differs from the
``DATA`` env literal or fewer than ``MIN_COUNT`` (default 1) arrived.
"""

from __future__ import annotations

import ast
import os
import sys

import pyarrow as pa

from dora_tpu_torch.node import Node


def main() -> None:
    raw = os.environ.get("DATA", "[1, 2, 3]")
    data = ast.literal_eval(raw)
    expected = pa.array(data if isinstance(data, list) else [data])
    received = 0
    with Node() as node:
        for event in node:
            if event["type"] == "INPUT":
                value = event["value"]
                if not value.equals(expected):
                    print(
                        f"assertion failed: got {value!r}, expected {expected!r}",
                        file=sys.stderr,
                    )
                    sys.exit(1)
                received += 1
            elif event["type"] == "STOP":
                break
    min_count = int(os.environ.get("MIN_COUNT", "1"))
    if received < min_count:
        print(f"expected at least {min_count} inputs, got {received}", file=sys.stderr)
        sys.exit(1)
    print(f"asserted {received} inputs OK")


if __name__ == "__main__":
    main()
