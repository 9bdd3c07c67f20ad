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
        "assert len(names) >= 12, names\n"
        "print(len(names), bad)\n"
        "assert not bad, bad\n"
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
    assert resolve_device("cpu") == torch.device("cpu")
    assert compute_dtype("cpu") == torch.float32
    assert compute_dtype("cuda") == torch.bfloat16


def test_qwen2_1_5b_shape():
    from dora_tpu_torch.models.hf import qwen2

    cfg = qwen2.Qwen2Config.qwen2_1_5b()
    assert (cfg.vocab, cfg.dim, cfg.layers, cfg.heads, cfg.kv_heads, cfg.head_dim,
            cfg.ffn, cfg.max_seq, cfg.tie_embeddings) == (
        151936, 1536, 28, 12, 2, 128, 8960, 2048, True)
    assert cfg.rope_theta == 1e6 and cfg.norm_eps == 1e-6
