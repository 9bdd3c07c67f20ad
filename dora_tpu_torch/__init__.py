"""dora_tpu_torch: the PyTorch/CUDA port of dora_tpu's serving path.

The JAX package ``dora_tpu`` stays the reference; this package is its
counterpart on torch tensors, with every Pallas kernel on the paged Qwen2
serving path rewritten by hand in CUDA C++ for Hopper (``csrc/``, built at
first use by ``ops/_build.py``). The module layout mirrors ``dora_tpu``
(``ops/decode_block.py`` here is the counterpart of
``dora_tpu/ops/decode_block.py``, and so on).

Rules the package keeps:

* it imports ``torch`` and ``numpy`` (``safetensors`` on the checkpoint
  path), never ``jax`` and never a module of ``dora_tpu``;
* entry points take ``device=`` and default to ``"cuda"``; without a card
  they raise unless the caller asked for ``device="cpu"``
  (:func:`resolve_device`);
* on CPU tensors every kernel wrapper runs its plain PyTorch version, on
  CUDA tensors it launches its kernel or raises.
"""

from dora_tpu_torch._device import compute_dtype, resolve_device

__version__ = "0.1.0"

__all__ = ["compute_dtype", "resolve_device"]
