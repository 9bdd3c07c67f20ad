"""Test-fixture node: send a literal pyarrow value
(dora_tpu/nodehub/pyarrow_sender.py).

Sends the Python literal of the ``DATA`` env var as one output ``COUNT``
times (default 1), ``DELAY`` seconds before each, then exits.
"""

from __future__ import annotations

import ast
import os
import time

import pyarrow as pa

from dora_tpu_torch.node import Node


def main() -> None:
    data = ast.literal_eval(os.environ.get("DATA", "[1, 2, 3]"))
    count = int(os.environ.get("COUNT", "1"))
    delay = float(os.environ.get("DELAY", "0"))  # seconds before each send
    with Node() as node:
        for _ in range(count):
            if delay:
                time.sleep(delay)
            node.send_output("data", pa.array(data if isinstance(data, list) else [data]))


if __name__ == "__main__":
    main()
