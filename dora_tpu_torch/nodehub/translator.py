"""The pretrained translation node of the port (Opus-MT / Marian), run as a
dora node by either package's daemon (dora_tpu/nodehub/translator.py).

Text in, translated text out through a Marian checkpoint: the port's
sentencepiece segmenter on the host, encode and greedy decode on the
device (models/hf/marian.py), detokenizing on the host.

Env:

- ``DORA_HF_CHECKPOINT``: the Marian safetensors directory (config.json,
  vocab.json, source.spm[, target.spm]). Required: the self-contained path
  is the ``make_translator`` operator.
- ``DORA_MAX_NEW_TOKENS`` (default 64), ``DORA_MAX_SRC`` (default 64): a
  longer source keeps its first pieces and its closing ``</s>``.
- ``DORA_SPEC_DECODE``: prompt-lookup speculation
  (``marian.translate_speculative``), the same tokens as greedy; the cache
  then holds the speculation headroom past ``DORA_MAX_NEW_TOKENS``.

Input events: ``text``, an Arrow string array (each element translated in
order), utf-8 bytes, or a numeric array of utf-8 bytes. Output: ``text``, an
Arrow string array. Dataflow usage (``--device`` defaults to cuda)::

    - id: opus
      path: module:dora_tpu_torch.nodehub.translator
      args: --device cuda
      inputs: {text: terminal-input/data}
      outputs: [text]
      env: {DORA_HF_CHECKPOINT: /path/to/opus-mt-en-de}
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Callable

import numpy as np


def texts_from_event(value) -> list[str]:
    """An input's texts: a string array's entries, else its bytes as one
    utf-8 text."""
    if isinstance(value, (bytes, bytearray, memoryview)):
        return [bytes(value).decode("utf-8", errors="replace")]
    if type(value).__module__.split(".")[0] == "pyarrow":
        import pyarrow as pa

        if isinstance(value, pa.ChunkedArray):
            value = value.combine_chunks()
        if pa.types.is_string(value.type) or pa.types.is_large_string(value.type):
            return [str(v) for v in value.to_pylist() if v is not None]
        value = value.to_numpy(zero_copy_only=False)
    if isinstance(value, np.ndarray):
        return [bytes(int(b) & 0xFF for b in value.reshape(-1)).decode("utf-8",
                                                                       errors="replace")]
    return [str(value)]


def encode_source(tok, cfg, text: str, max_src: int, device=None):
    """A text as the node feeds it to Marian: its pieces' ids (trimmed to
    ``max_src`` with the closing ``</s>`` kept), padded with ``pad_token``
    to ``max_src``; returns (src [1, max_src] int32, mask [1, max_src]
    bool)."""
    import torch

    ids = tok.encode(text)
    if len(ids) > max_src:
        ids = ids[: max_src - 1] + [tok.eos_id]
    src = torch.full((1, max_src), cfg.pad_token, dtype=torch.int32)
    src[0, : len(ids)] = torch.tensor(ids, dtype=torch.int32)
    mask = torch.arange(max_src)[None, :] < len(ids)
    return src.to(device), mask.to(device)


def translate_fn(cfg, params, tok, max_new: int, max_src: int,
                 speculative: bool = False) -> Callable[[str], str]:
    """One text -> its translation: :func:`encode_source`, greedy (or
    speculative) decode, the tokens cut at the first EOS, detokenized."""
    from dora_tpu_torch.models.hf import marian

    dev = params["embed"].device

    def translate_one(text: str) -> str:
        src, mask = encode_source(tok, cfg, text, max_src, dev)
        if speculative:
            tokens, _ = marian.translate_speculative(params, cfg, src, max_new, src_mask=mask)
        else:
            tokens = marian.translate(params, cfg, src, max_new, src_mask=mask)
        keep = []
        for t in tokens[0].tolist():
            if t == cfg.eos_token:
                break
            keep.append(t)
        return tok.decode(keep)

    return translate_one


def build(checkpoint: str, device=None) -> Callable[[str], str]:
    """The node's translate function over ``checkpoint``, from the env's
    knobs."""
    from dora_tpu_torch.models import spec_decode
    from dora_tpu_torch.models.hf import marian

    max_new = int(os.environ.get("DORA_MAX_NEW_TOKENS", "64"))
    max_src = int(os.environ.get("DORA_MAX_SRC", "64"))
    spec = bool(os.environ.get("DORA_SPEC_DECODE"))
    # speculation writes up to k + 1 rows past the last token: size the cache for it
    max_tokens = max_new + 1 + spec_decode.spec_headroom() if spec else max_new
    cfg, params = marian.load(checkpoint, max_tokens=max_tokens, device=device)
    return translate_fn(cfg, params, marian.MarianTokenizer(checkpoint), max_new, max_src,
                        speculative=spec)


def serve(node, translate_one: Callable[[str], str]) -> None:
    """Answer every INPUT with the translations of its texts, as one Arrow
    string array on ``text``, until STOP or the end of the inputs."""
    import pyarrow as pa

    for event in node:
        if event["type"] == "STOP":
            break
        if event["type"] == "INPUT":
            node.send_output("text", pa.array([translate_one(t)
                                               for t in texts_from_event(event["value"])]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    checkpoint = os.environ.get("DORA_HF_CHECKPOINT")
    if not checkpoint:
        raise RuntimeError(
            "dora_tpu_torch.nodehub.translator serves a pretrained Marian checkpoint; set "
            "DORA_HF_CHECKPOINT (the self-contained path is the make_translator operator)")
    translate_one = build(checkpoint, device=args.device)

    from dora_tpu_torch.node import Node

    with Node() as node:
        serve(node, translate_one)
    return 0


if __name__ == "__main__":
    sys.exit(main())
