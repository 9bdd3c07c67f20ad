"""The port stands alone: importing every module of dora_tpu_torch loads
neither jax nor dora_tpu, and entry points refuse to fall back to the CPU."""

from __future__ import annotations

import os
import subprocess
import sys

import pytest
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax_and_no_dora_tpu():
    code = (
        "import pkgutil, importlib, sys, dora_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(dora_tpu_torch.__path__, 'dora_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'dora_tpu'))\n"
        "assert len(names) >= 40, names\n"
        "assert {'dora_tpu_torch.ops.lora', 'dora_tpu_torch.models.lora_pool',\n"
        "        'dora_tpu_torch.models.spec_decode', 'dora_tpu_torch.ops.int8_matmul',\n"
        "        'dora_tpu_torch.models.tokenizer', 'dora_tpu_torch.nodehub.ops',\n"
        "        'dora_tpu_torch.ops.flash_attention', 'dora_tpu_torch.profiling',\n"
        "        'dora_tpu_torch.ops.int4', 'dora_tpu_torch.clock', 'dora_tpu_torch.native',\n"
        "        'dora_tpu_torch.message.serde', 'dora_tpu_torch.message.common',\n"
        "        'dora_tpu_torch.message.daemon_to_node', 'dora_tpu_torch.message.node_to_daemon',\n"
        "        'dora_tpu_torch.transport.framing', 'dora_tpu_torch.core.topics',\n"
        "        'dora_tpu_torch.telemetry', 'dora_tpu_torch.metrics',\n"
        "        'dora_tpu_torch.metrics_history', 'dora_tpu_torch.fleet', 'dora_tpu_torch.node',\n"
        "        'dora_tpu_torch.node.arrow', 'dora_tpu_torch.node.channels',\n"
        "        'dora_tpu_torch.node.events', 'dora_tpu_torch.models.checkpoint',\n"
        "        'dora_tpu_torch.models.hf.qwen2_vl',\n"
        "        'dora_tpu_torch.models.hf.internvl', 'dora_tpu_torch.runtime',\n"
        "        'dora_tpu_torch.tpu.api', 'dora_tpu_torch.tpu.bridge', 'dora_tpu_torch.tpu.fuse',\n"
        "        'dora_tpu_torch.core.config', 'dora_tpu_torch.core.descriptor',\n"
        "        'dora_tpu_torch.models.hf.whisper', 'dora_tpu_torch.models.asr',\n"
        "        'dora_tpu_torch.models.hf.wav2vec2', 'dora_tpu_torch.models.vad',\n"
        "        'dora_tpu_torch.models.spm', 'dora_tpu_torch.models.detection',\n"
        "        'dora_tpu_torch.models.hf.yolos', 'dora_tpu_torch.models.translation',\n"
        "        'dora_tpu_torch.models.hf.marian', 'dora_tpu_torch.models.tts',\n"
        "        'dora_tpu_torch.models.hf.vits', 'dora_tpu_torch.nodehub.translator'} <= set(names)\n"
        "from dora_tpu_torch.models import tokenizer, vlm\n"
        "from dora_tpu_torch.nodehub import ops\n"
        "assert all(callable(getattr(ops, f)) for f in ('make_vlm', 'make_asr', 'make_vad',\n"
        "           'make_detector', 'make_translator', 'make_tts'))\n"
        "from dora_tpu_torch.ops import flash_attention\n"
        "assert callable(tokenizer.BPETokenizer) and callable(ops._hf_tokenizer)\n"
        "assert callable(flash_attention.flash_attention) and callable(vlm.generate_speculative)\n"
        "from dora_tpu_torch.models import spec_decode, batch_engine\n"
        "from dora_tpu_torch.ops import int8_matmul, decode_block\n"
        "assert all(callable(getattr(spec_decode, f)) for f in ('run_loop', 'body_passes',\n"
        "           'fitting_body_passes', 'check_headroom', 'spec_headroom', 'lookup',\n"
        "           'fits', 'gate_speculation'))\n"
        "assert callable(batch_engine.BatchEngine) and callable(int8_matmul.int8_matmul)\n"
        "assert callable(decode_block.attention_chunk_step)\n"
        "from dora_tpu_torch.models.hf import internvl, qwen2_vl\n"
        "assert all(callable(getattr(m, f)) for m in (qwen2_vl, internvl) for f in\n"
        "           ('load', 'map_params', 'encode_images', 'forward', 'generate',\n"
        "            'generate_speculative', 'quantize_decode', 'make_serving_step',\n"
        "            'build_prompt_ids'))\n"
        "print(len(names), bad)\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=_REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_serving_node_loads_no_wire_packages_until_it_talks():
    """The serving loop, the admission queue, the engine, the metrics and
    the fleet digest run without pyarrow and msgpack (the card's machine
    need not have them): importing nodehub.llm_server and serving a
    scripted node on the stub engine load neither; only the node's data
    plane (dora_tpu_torch.node) does."""
    code = (
        "import sys\n"
        "from dora_tpu_torch.nodehub import llm_server\n"
        "from dora_tpu_torch.metrics import ServingMetrics\n"
        "from dora_tpu_torch.models.batch_engine import make_stub_paged_engine\n"
        "class N:\n"
        "    stream_ended = False\n"
        "    def __init__(self):\n"
        "        self.events = [{'type': 'INPUT', 'metadata': {'request_id': 'a'}, 'value': b'hi'}]\n"
        "        self.sent, self.digests = [], []\n"
        "    def recv(self, timeout=None):\n"
        "        if self.events:\n"
        "            return self.events.pop()\n"
        "        self.stream_ended = True\n"
        "    def send_output(self, oid, value, meta): self.sent.append((value, meta))\n"
        "    def report_serving(self, snap): pass\n"
        "    def report_engine_state(self, digest): self.digests.append(digest)\n"
        "    def close(self): pass\n"
        "node = N()\n"
        "llm_server.serve(node, make_stub_paged_engine(device='cpu'), ServingMetrics(),\n"
        "                 encode=lambda t: [1, 2], decode_one=str, max_new_cap=4)\n"
        "assert len(node.sent) == 4 and node.sent[-1][1]['done'] and node.digests\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('pyarrow', 'msgpack', 'jax', 'jaxlib', 'dora_tpu'))\n"
        "assert not bad, bad\n"
        "import dora_tpu_torch.node\n"
    )
    env = dict(os.environ, PYTHONPATH=_REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_default_device_entry_points_raise_without_cuda(monkeypatch):
    from dora_tpu_torch import compute_dtype, resolve_device
    from dora_tpu_torch.models.hf import qwen2
    from dora_tpu_torch.models.layers import rope_table

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = qwen2.Qwen2Config.qwen2_1_5b(layers=1, max_seq=64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        qwen2.init_page_pool(cfg, 4, 16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        qwen2.params_from_jax({"embed": [[0.0]]})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rope_table(64, 16)
    from dora_tpu_torch.models.batch_engine import make_stub_paged_engine

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_stub_paged_engine()
    assert resolve_device("cpu") == torch.device("cpu")
    assert compute_dtype("cpu") == torch.float32
    assert compute_dtype("cuda") == torch.bfloat16


def test_hub_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """The hub models' factories, loaders and initializers default to cuda
    and refuse without it, before they read anything."""
    from dora_tpu_torch.models import detection, translation, tts
    from dora_tpu_torch.models.hf import marian, vits, yolos
    from dora_tpu_torch.nodehub import ops

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("DORA_MODEL_SIZE", "tiny")
    monkeypatch.delenv("DORA_HF_CHECKPOINT", raising=False)
    for fn in (ops.make_detector, ops.make_translator, ops.make_tts,
               lambda: detection.init_params(detection.DetectorConfig.tiny()),
               lambda: translation.init_params(translation.TranslatorConfig.tiny()),
               lambda: tts.init_params(tts.TTSConfig.tiny()),
               lambda: yolos.load(tmp_path), lambda: marian.load(tmp_path),
               lambda: vits.load(tmp_path)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn()


def test_qwen2_1_5b_shape():
    from dora_tpu_torch.models.hf import qwen2

    cfg = qwen2.Qwen2Config.qwen2_1_5b()
    assert (cfg.vocab, cfg.dim, cfg.layers, cfg.heads, cfg.kv_heads, cfg.head_dim,
            cfg.ffn, cfg.max_seq, cfg.tie_embeddings) == (
        151936, 1536, 28, 12, 2, 128, 8960, 2048, True)
    assert cfg.rope_theta == 1e6 and cfg.norm_eps == 1e-6
