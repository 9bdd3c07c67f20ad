"""Test-fixture node: echo every input back out on ``echo``, with its
metadata (dora_tpu/nodehub/echo.py).
"""

from __future__ import annotations

from dora_tpu_torch.node import Node


def main() -> None:
    with Node() as node:
        for event in node:
            if event["type"] == "INPUT":
                node.send_output("echo", event["value"], event["metadata"])
            elif event["type"] == "STOP":
                break


if __name__ == "__main__":
    main()
