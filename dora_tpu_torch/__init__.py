"""dora_tpu_torch: the PyTorch/CUDA port of dora_tpu's serving path.

The JAX package ``dora_tpu`` stays the reference; this package is its
counterpart on torch tensors, with every Pallas kernel on the paged Qwen2
serving path rewritten by hand in CUDA C++ for Hopper (``csrc/``, built at
first use by ``ops/_build.py``). The module layout mirrors ``dora_tpu``
(``ops/decode_block.py`` here is the counterpart of
``dora_tpu/ops/decode_block.py``, and so on).

It also carries its own serving node (``nodehub/llm_server.py``): a dora
node that the JAX package's daemon spawns and runs unchanged, speaking its
wire byte for byte through the port's copies of the node API (``node/``),
the message codec (``message/``), the clock, the framing and the
shared-memory layer (``native.py`` over ``csrc/shmem.cpp``), with the
trace, metrics and fleet planes the node reports through. Its operator
tier (``runtime/``, ``tpu/``: a runtime node hosting torch operators, the
counterpart of ``python -m dora_tpu.runtime``) runs the model-zoo factories
of ``nodehub/ops.py`` (the VLMs, Whisper and the ASR, Wav2Vec2 and the VAD)
as dataflow operators.

Rules the package keeps:

* it imports ``torch`` and ``numpy`` (``safetensors`` on the checkpoint
  path), never ``jax`` and never a module of ``dora_tpu``;
* the node's wire adds host-only dependencies, each imported only where
  the node talks to its daemon: ``msgpack`` in ``message/serde.py``'s
  ``encode`` / ``decode``, ``pyarrow`` in ``node/arrow.py`` (loaded by
  ``node/`` for Arrow payloads), and ``g++`` to build ``csrc/shmem.cpp``
  into ``_build/`` at the first shared-memory use (``native.py``). The
  serving loop, the engines and the metrics need none of them;
* entry points take ``device=`` and default to ``"cuda"``; without a card
  they raise unless the caller asked for ``device="cpu"``
  (:func:`resolve_device`);
* on CPU tensors every kernel wrapper runs its plain PyTorch version, on
  CUDA tensors it launches its kernel or raises.
"""

from dora_tpu_torch._device import compute_dtype, resolve_device

__version__ = "0.1.0"

#: the node wire's protocol version, dora_tpu's: a daemon refuses a node
#: registering with an incompatible one
PROTOCOL_VERSION = "0.1.0"

__all__ = ["compute_dtype", "resolve_device"]
