"""Print every input to stdout (dora_tpu/nodehub/terminal_print.py). Run
it inside a dataflow (``path: module:dora_tpu_torch.nodehub.terminal_print``)
or attach it as a dynamic node (``path: dynamic``, this module run with
``NODE_ID`` set).
"""

from __future__ import annotations

import os

from dora_tpu_torch.node import Node


def main() -> None:
    node_id = os.environ.get("NODE_ID")
    daemon_addr = os.environ.get("DORA_DAEMON_ADDR")
    node = Node(node_id=node_id, daemon_addr=daemon_addr) if node_id else Node()
    try:
        for event in node:
            if event["type"] == "INPUT":
                print(f"[{event['id']}] {event['value']}", flush=True)
            elif event["type"] == "STOP":
                break
    finally:
        node.close()


if __name__ == "__main__":
    main()
