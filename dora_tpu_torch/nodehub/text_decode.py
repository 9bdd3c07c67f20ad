"""Token ids -> text decoder node (dora_tpu/nodehub/text_decode.py).

The model operators emit token ids; sinks that want text (the OpenAI
gateway, a printer) read this node's ``text`` output: each input's ids
decoded to one string, with the byte-level BPE vocabulary of
``DORA_TOKENIZER`` (a directory or a tokenizer.json) when it is set, else
with the byte codec (``models/tokenizer.py``). A string input passes as its
utf-8 bytes. Host only: it imports neither torch nor numpy.
"""

from __future__ import annotations

import os

import pyarrow as pa

from dora_tpu_torch.node import Node


def make_decoder():
    path = os.environ.get("DORA_TOKENIZER")
    if path:
        from dora_tpu_torch.models.tokenizer import BPETokenizer

        tok = BPETokenizer.from_file(path)
        return lambda ids: tok.decode([int(i) for i in ids])
    from dora_tpu_torch.models import tokenizer

    return tokenizer.decode


def ids_of(value) -> list[int]:
    """An input's token ids, flattened (the ``shape`` metadata only folds
    them); a string array as the utf-8 bytes of its entries joined by
    spaces."""
    if pa.types.is_string(value.type) or pa.types.is_large_string(value.type):
        return list(" ".join(s for s in value.to_pylist() if s is not None).encode())
    return [int(i) for i in value.to_pylist()]


def main() -> None:
    decode = make_decoder()
    with Node() as node:
        for event in node:
            if event["type"] == "STOP":
                break
            if event["type"] != "INPUT":
                continue
            node.send_output("text", pa.array([decode(ids_of(event["value"]))]))


if __name__ == "__main__":
    main()
