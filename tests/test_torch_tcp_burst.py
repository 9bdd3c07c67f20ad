"""A burst from a sender that exits at once, into a receiver busy for longer
than the sender's region wait, under the port's daemon over tcp with the
daemon route (``DORA_P2P=0``), on the CPU.

The shape of phase 20 (b)'s prompts in chip_smoke.py: 16 Arrow string
messages, the larger ones in shared memory, sent back to back by a node
that closes right after; the receiver takes the first and then stays busy
for ``DROP_TOKEN_WAIT_S`` + 2 s, the longest a closing sender keeps its
regions for receivers that have not released them. The receiver must get
all 16, in order, with their contents.
"""

from __future__ import annotations

import json
import textwrap

import pytest
import torch

from dora_tpu_torch.core.descriptor import Descriptor
from dora_tpu_torch.daemon import run_dataflow
from dora_tpu_torch.node import DROP_TOKEN_WAIT_S

#: (seq, characters) of the 16 prompts: every other one past the zero-copy
#: threshold, as phase 4's long prompts are
PROMPTS = [(i, 6000 + 500 * i if i % 2 else 40 + i) for i in range(16)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SENDER = """
import pyarrow as pa
from dora_tpu_torch.node import Node

with Node() as node:
    for seq, n in {prompts}:
        node.send_output("prompt", pa.array([str(seq % 10) * n]), {{"seq": seq}})
"""

BUSY_RECEIVER = """
import json
import time
from dora_tpu_torch.node import Node

got = []
with Node() as node:
    for event in node:
        if event["type"] == "INPUT":
            text = event["value"].to_pylist()[0]
            got.append([event["metadata"]["seq"], len(text), text[:1]])
            del event
            if len(got) == 1:
                time.sleep({busy_s})  # busy, as a serving node in a long step
json.dump(got, open("got.json", "w"))
"""


def test_burst_from_an_exiting_sender_reaches_a_busy_receiver(tmp_path, monkeypatch):
    monkeypatch.setenv("DORA_P2P", "0")
    (tmp_path / "sender.py").write_text(textwrap.dedent(SENDER.format(prompts=PROMPTS)))
    (tmp_path / "receiver.py").write_text(textwrap.dedent(
        BUSY_RECEIVER.format(busy_s=DROP_TOKEN_WAIT_S + 2)))
    spec = {"nodes": [
        {"id": "prompts", "path": "sender.py", "outputs": ["prompt"]},
        {"id": "llm", "path": "receiver.py",
         "inputs": {"text": {"source": "prompts/prompt", "queue_size": 64}}},
    ]}
    result = run_dataflow(Descriptor.parse(spec), working_dir=tmp_path, local_comm="tcp",
                          timeout_s=90)
    logs = {p.name: p.read_text()[-2000:] for p in (tmp_path / "out").glob("*/log_*.txt")}
    assert result.is_ok(), (result.errors(), logs)
    got = json.loads((tmp_path / "got.json").read_text())
    assert got == [[seq, n, str(seq % 10)] for seq, n in PROMPTS], logs
