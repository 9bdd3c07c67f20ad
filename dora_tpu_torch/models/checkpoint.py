"""Save and restore a dict of tensors, in place.

Counterpart of dora_tpu/models/checkpoint.py, which saves pytrees with
orbax; the port has its own format (one ``torch.save`` file of CPU copies,
nested dict keys joined by ``/``), and a file of one stack does not load in
the other. The serving node persists the paged engine's KV pools with it
(``PagedBatchEngine.save_pools`` / ``restore_pools``).

:func:`restore` copies into the tensors it is given and never replaces
them: the engine's CUDA graphs hold the pools' addresses, so a restored
pool must be the same tensor as before.
"""

from __future__ import annotations

import os
from pathlib import Path

import torch


def _flat(tree, prefix: str = "") -> dict[str, torch.Tensor]:
    """``{"0": {"k": t}}`` -> ``{"0/k": t}``."""
    out: dict[str, torch.Tensor] = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            out.update(_flat(value, name + "/"))
        else:
            out[name] = value
    return out


def save(path: str | Path, tensors: dict) -> None:
    """Write CPU copies of a (nested) dict of tensors to ``path``
    atomically: a temporary file beside it, then a rename, so a crash
    mid-write leaves the previous file whole."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    torch.save({k: t.detach().to("cpu") for k, t in _flat(tensors).items()}, tmp)
    os.replace(tmp, path)


def restore(path: str | Path, like: dict) -> dict:
    """Load ``path`` (tensors only: ``weights_only``) into the tensors of
    ``like`` in place, after checking that its keys, shapes and dtypes are
    exactly ``like``'s; returns ``like``."""
    saved = torch.load(Path(path), map_location="cpu", weights_only=True)
    dst = _flat(like)
    if set(saved) != set(dst):
        raise ValueError(f"checkpoint {path}: keys {sorted(saved)} do not match "
                         f"{sorted(dst)}")
    for key, t in dst.items():
        src = saved[key]
        if src.shape != t.shape or src.dtype != t.dtype:
            raise ValueError(f"checkpoint {path}: {key} is {src.dtype} "
                             f"{tuple(src.shape)}, expected {t.dtype} {tuple(t.shape)}")
    for key, t in dst.items():
        t.copy_(saved[key])
    return like
