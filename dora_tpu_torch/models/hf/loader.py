"""Checkpoint directory reading: safetensors (single file or sharded) and
config.json, as torch tensors.

Counterpart of dora_tpu/models/hf/loader.py; it reads through
``safetensors.torch`` so that bf16 checkpoints load too.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch


def read_config(model_dir: str | Path) -> dict:
    return json.loads((Path(model_dir) / "config.json").read_text())


def read_safetensors(model_dir: str | Path) -> dict[str, torch.Tensor]:
    """All tensors of a checkpoint dir keyed by their checkpoint names.

    Handles both single-file ``model.safetensors`` and sharded
    ``model.safetensors.index.json`` layouts."""
    from safetensors.torch import load_file

    model_dir = Path(model_dir)
    index = model_dir / "model.safetensors.index.json"
    tensors: dict[str, torch.Tensor] = {}
    if index.exists():
        weight_map = json.loads(index.read_text())["weight_map"]
        for shard in sorted(set(weight_map.values())):
            tensors.update(load_file(model_dir / shard))
        return tensors
    single = model_dir / "model.safetensors"
    if single.exists():
        return load_file(single)
    candidates = sorted(model_dir.glob("*.safetensors"))
    if not candidates:
        raise FileNotFoundError(f"no safetensors files under {model_dir}")
    for path in candidates:
        tensors.update(load_file(path))
    return tensors


def linear(tensors: dict, name: str) -> torch.Tensor:
    """HF nn.Linear weight [out, in] -> matmul layout [in, out]."""
    return tensors[name].T.contiguous()


def maybe_bias(params: dict, key: str, tensors: dict, name: str) -> None:
    """Attach a bias parameter when the checkpoint has one."""
    if name in tensors:
        params[key] = tensors[name]


def to_device(tree, device) -> dict:
    """A parameter tree (nested dicts of tensors) as f32 on ``device``:
    checkpoints saved in f16 or bf16 widen exactly; each model casts to its
    compute dtype where it multiplies."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree.to(device=device, dtype=torch.float32)
