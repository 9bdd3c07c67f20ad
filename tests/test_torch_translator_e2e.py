"""The port's Opus-MT node (``dora_tpu_torch.nodehub.translator``) as a
dataflow node under the JAX package's daemon, on the CPU.

A source sends three Arrow string arrays (two texts, one, then a text
longer than ``DORA_MAX_SRC`` pieces) to the node, which serves a tiny
Marian checkpoint that ``transformers`` builds offline, with a fabricated
sentencepiece model and ``vocab.json``; a sink records every ``text`` it
answers. The records must equal, text for text, what the JAX package's
node computes for the same inputs (its tokenizer, ``marian.translate`` on
the source padded and masked to ``DORA_MAX_SRC``, the tokens cut at the
first EOS, detokenized), run here in the test process. Every edge goes
through the daemon (``DORA_P2P=0``; the port's node announces no
peer-to-peer listener) with inline payloads; the run has a limit of 45 s.
"""

from __future__ import annotations

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from dora_tpu.daemon import run_dataflow
from dora_tpu.models.hf import marian as jmarian
from dora_tpu_torch.models import spm

transformers = pytest.importorskip("transformers")

LIMIT_S = 45
MAX_NEW, MAX_SRC = 8, 10
BATCHES = [["the cat sat", "the dog"], ["the cats"],
           ["the cat sat the dog sat the cat sat the dog sat"]]

SOURCE = """
import json
import sys
import time

import pyarrow as pa

from dora_tpu.node import Node

with Node() as node:
    time.sleep(0.3)
    for texts in json.loads(sys.argv[1]):
        node.send_output("text", pa.array(texts))
        time.sleep(0.2)
"""

SINK = """
import json
import sys

from dora_tpu.node import Node

records = []
with Node() as node:
    for event in node:
        if event["type"] == "INPUT":
            records.append(event["value"].to_pylist())
with open(sys.argv[1], "w") as f:
    json.dump(records, f)
"""

PIECES = [("<unk>", 0.0, spm.TYPE_UNKNOWN), ("<s>", 0.0, spm.TYPE_CONTROL),
          ("</s>", 0.0, spm.TYPE_CONTROL), ("▁", -4.0, spm.TYPE_NORMAL),
          ("▁the", -1.0, spm.TYPE_NORMAL), ("▁cat", -2.0, spm.TYPE_NORMAL),
          ("▁dog", -2.2, spm.TYPE_NORMAL), ("▁sat", -2.4, spm.TYPE_NORMAL),
          ("s", -3.0, spm.TYPE_NORMAL), ("a", -3.1, spm.TYPE_NORMAL),
          ("t", -3.2, spm.TYPE_NORMAL)]


def _checkpoint(path):
    from transformers import MarianConfig, MarianMTModel

    config = MarianConfig(
        vocab_size=97, d_model=32, encoder_layers=2, decoder_layers=2,
        encoder_attention_heads=4, decoder_attention_heads=4, encoder_ffn_dim=64,
        decoder_ffn_dim=64, max_position_embeddings=64, scale_embedding=True,
        activation_function="swish", pad_token_id=96, eos_token_id=0,
        decoder_start_token_id=96)
    torch.manual_seed(7)
    MarianMTModel(config).eval().save_pretrained(path, safe_serialization=True)
    (path / "source.spm").write_bytes(spm.build_model_proto(PIECES))
    # vocab ids spread over the model's vocabulary, so the decoded text has words
    vocab = {"<unk>": 1, "</s>": 0, "<pad>": 96}
    for i, (piece, _, _) in enumerate(PIECES[3:]):
        vocab[piece] = 2 + 11 * i
    for i in range(97):
        if i not in vocab.values():
            vocab[f"w{i}"] = i
    (path / "vocab.json").write_text(json.dumps(vocab))


def _jax_node(path) -> list[list[str]]:
    """What the JAX package's node answers (dora_tpu/nodehub/translator.py's
    translate_one) for each batch."""
    cfg, params = jmarian.load(path, max_tokens=MAX_NEW)
    tok = jmarian.MarianTokenizer(path)

    def translate_one(text):
        ids = tok.encode(text)
        if len(ids) > MAX_SRC:
            ids = ids[: MAX_SRC - 1] + [tok.eos_id]
        src = np.full((1, MAX_SRC), cfg.pad_token, np.int32)
        src[0, : len(ids)] = ids
        mask = jnp.asarray(np.arange(MAX_SRC)[None, :] < len(ids))
        out = np.asarray(jmarian.translate(params, cfg, jnp.asarray(src), MAX_NEW,
                                           src_mask=mask))[0]
        keep = []
        for t in out:
            if int(t) == cfg.eos_token:
                break
            keep.append(int(t))
        return tok.decode(keep)

    return [[translate_one(t) for t in texts] for texts in BATCHES]


def test_port_opus_node_under_the_jax_daemon(tmp_path):
    ckpt = tmp_path / "opus"
    ckpt.mkdir()
    _checkpoint(ckpt)
    (tmp_path / "source.py").write_text(SOURCE)
    (tmp_path / "sink.py").write_text(SINK)
    records = tmp_path / "records.json"
    env = {"OMP_NUM_THREADS": "1", "DORA_P2P": "0"}
    spec = {"nodes": [
        {"id": "source", "path": "source.py", "args": json.dumps(json.dumps(BATCHES)),
         "outputs": ["text"], "env": env},
        {"id": "opus", "path": "module:dora_tpu_torch.nodehub.translator",
         "args": "--device cpu", "inputs": {"text": "source/text"}, "outputs": ["text"],
         "env": {**env, "DORA_HF_CHECKPOINT": str(ckpt), "DORA_MAX_NEW_TOKENS": str(MAX_NEW),
                 "DORA_MAX_SRC": str(MAX_SRC)}},
        {"id": "sink", "path": "sink.py", "args": str(records),
         "inputs": {"text": "opus/text"}, "env": env},
    ]}
    df = tmp_path / "dataflow.yml"
    df.write_text(yaml.safe_dump(spec))
    result = run_dataflow(df, timeout_s=LIMIT_S)
    logs = {p.name: p.read_text()[-3000:] for p in next((tmp_path / "out").iterdir()).iterdir()}
    assert result.is_ok(), (result.errors(), logs)
    got = json.loads(records.read_text())
    want = _jax_node(ckpt)
    assert got == want
    assert any(text for batch in got for text in batch)  # not all empty
