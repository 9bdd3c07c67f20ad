"""Helpers of the model-zoo operator factories, on the port's side.

Counterpart of the checkpoint helpers of dora_tpu/nodehub/ops.py. Only
``_hf_tokenizer`` is ported so far: the serving entry (nodehub/llm_server.py)
reads a checkpoint's tokenizer through it. The operator factories
themselves (``make_vlm`` and the rest) wait for a port of the operator
tier.
"""

from __future__ import annotations

from pathlib import Path


def _hf_tokenizer(path: str):
    """The byte-level BPE tokenizer of a checkpoint directory that ships a
    ``tokenizer.json``, else None."""
    from dora_tpu_torch.models.tokenizer import BPETokenizer

    if (Path(path) / "tokenizer.json").exists():
        return BPETokenizer.from_file(path)
    return None
