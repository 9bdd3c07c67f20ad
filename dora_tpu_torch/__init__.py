"""dora_tpu_torch: the PyTorch/CUDA port of dora_tpu's serving path.

The JAX package ``dora_tpu`` stays the reference; this package is its
counterpart on torch tensors, with every Pallas kernel on the paged Qwen2
serving path rewritten by hand in CUDA C++ for Hopper (``csrc/``, built at
first use by ``ops/_build.py``). The module layout mirrors ``dora_tpu``
(``ops/decode_block.py`` here is the counterpart of
``dora_tpu/ops/decode_block.py``, and so on).

It also carries its own dataflow runtime, on the host: the descriptor
(``core/``), a daemon that spawns a dataflow's nodes, routes their
messages over tcp, a Unix socket or shared memory, runs their timers and
restarts them (``daemon/``, ``python -m dora_tpu_torch.cli run``), the
cluster tier (``coordinator/``, the daemon's attached mode and its links
between machines, the CLI's ``up`` / ``start`` / ``stop`` / ``list`` /
``logs`` / ``metrics`` / ``migrate`` / ``destroy``), the node
API (``node/``), the message codec (``message/``), the clock, the framing,
the shared-memory layer (``native.py`` over ``csrc/shmem.cpp``) and the
host nodes of its examples (``nodehub/``: camera, microphone, printer,
recorder, speaker, plot; the OpenAI gateway and the text decoder). The wire
is the JAX package's byte for byte, so a node of either package runs under
either daemon, and a coordinator of either package runs daemons of both. Its serving node
(``nodehub/llm_server.py``) and its operator tier (``runtime/``, ``tpu/``: a
runtime node hosting torch operators, the counterpart of ``python -m
dora_tpu.runtime``) run the model-zoo factories of ``nodehub/ops.py`` (the
VLMs, Whisper and the ASR, Wav2Vec2 and the VAD, the detectors, the
translators and the TTS) as dataflow nodes.

Rules the package keeps:

* it imports ``torch`` and ``numpy`` (``safetensors`` on the checkpoint
  path), never ``jax`` and never a module of ``dora_tpu``; the daemon, the
  descriptor and the CLI import neither torch nor jax (torch loads with the first use of
  :func:`resolve_device`, not with the package);
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

__version__ = "0.1.0"

#: the node wire's protocol version, dora_tpu's: a daemon refuses a node
#: registering with an incompatible one
PROTOCOL_VERSION = "0.1.0"

__all__ = ["compute_dtype", "resolve_device"]


def __getattr__(name: str):
    # torch loads with the first use of these, not with the package: the
    # daemon, the CLI and the host nodes run without it
    if name in __all__:
        from dora_tpu_torch import _device

        return getattr(_device, name)
    raise AttributeError(f"module 'dora_tpu_torch' has no attribute {name!r}")
