"""Interactive dynamic sender (dora_tpu/nodehub/terminal_input.py): a
*dynamic* node (``path: dynamic`` in the YAML) started by hand; each typed
line is parsed with ``ast.literal_eval`` (falling back to a string) and sent
on the ``data`` output, and whatever is routed back is printed. With
``DATA`` set it sends that one value and exits (the non-interactive path).

It connects with ``NODE_ID`` (and ``DORA_DAEMON_ADDR``), as every dynamic
node does, and retries until the dataflow is up.
"""

from __future__ import annotations

import ast
import os
import sys
import time

from dora_tpu_torch.node import Node


def parse_value(text: str):
    """``ast.literal_eval`` with the reference's fall-back-to-string rule."""
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text


def _to_payload(value):
    import pyarrow as pa

    if isinstance(value, (list, tuple)):
        return pa.array(list(value))
    return pa.array([value])


def _connect(node_id: str | None) -> Node:
    daemon_addr = os.environ.get("DORA_DAEMON_ADDR")
    if not node_id:
        # Spawned mode: a failure here (e.g. no DORA_NODE_CONFIG) is
        # permanent — surface it instead of retrying.
        return Node()
    last_err = ""
    while True:
        try:
            return Node(node_id=node_id, daemon_addr=daemon_addr)
        except (OSError, RuntimeError) as err:  # dataflow not up yet
            if str(err) != last_err:
                print(err)
                last_err = str(err)
            print("Waiting for dataflow to be spawned", flush=True)
            time.sleep(1)


def main() -> None:
    node_id = os.environ.get("NODE_ID")
    data = os.environ.get("DATA")
    node = _connect(node_id)
    try:
        if data is not None:
            node.send_output("data", _to_payload(parse_value(data)))
            return
        while True:
            try:
                line = input("Provide the data you want to send:  ")
            except EOFError:
                break
            node.send_output("data", _to_payload(parse_value(line)))
            # Drain replies briefly so request/response demos read naturally.
            while True:
                event = node.next(timeout=0.2)
                if event is not None and event["type"] == "INPUT":
                    print(f"Received: {event['value']}", flush=True)
                else:
                    break
    finally:
        node.close()


if __name__ == "__main__":
    main()
