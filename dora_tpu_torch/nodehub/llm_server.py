"""LLM serving entry of the port: build the paged engine and answer prompts.

Counterpart of ``make_engine`` and ``main`` of dora_tpu/nodehub/llm_server.py.
``make_engine`` reads the same knobs with the same meaning
(``DORA_BATCH_SLOTS``, ``DORA_PAGE_SIZE``, ``DORA_PREFILL_CHUNK``,
``DORA_MULTISTEP_K``); the prefix cache, which the JAX front door turns on,
is not ported yet, so this engine runs without it. ``main`` answers a list
of token-id prompts through ``submit``/``step``; wiring it into a dataflow
node waits for a port of the node API.

Usage::

    python -m dora_tpu_torch.nodehub.llm_server --prompts prompts.json
    python -m dora_tpu_torch.nodehub.llm_server --prompts prompts.json \\
        --random-config qwen2_1_5b --max-new 128

``prompts.json`` is a JSON list of token-id lists. Weights come from the
checkpoint directory in ``DORA_HF_CHECKPOINT`` (``DORA_MAX_SEQ`` caps the
context), or are seeded random at a named config with ``--random-config``.
One JSON line per request goes to stdout.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import deque


def make_engine(params, cfg, eos=None, device=None):
    """The paged serving engine from the env knobs."""
    from dora_tpu_torch.models.hf import qwen2

    chunk_env = os.environ.get("DORA_PREFILL_CHUNK")
    return qwen2.make_paged_engine(
        params, cfg,
        max_slots=int(os.environ.get("DORA_BATCH_SLOTS", "16")),
        eos=eos,
        page_size=int(os.environ.get("DORA_PAGE_SIZE", "16")),
        chunk=int(chunk_env) if chunk_env else None,
        window=int(os.environ.get("DORA_MULTISTEP_K", "8")),
        device=device,
    )


def serve_prompts(engine, prompts, max_new: int, on_token=None):
    """Serve every prompt to completion, admitting in order: a request the
    engine cannot admit yet waits at the head of the line until slots and
    pages free up. Returns {request index: tokens} and per-request
    time-to-first-token seconds (from the start of the run).
    ``on_token(index, token, done)`` sees every emission."""
    waiting = deque(range(len(prompts)))
    for i in waiting:
        if not engine.fits(len(prompts[i]), max_new):
            raise ValueError(f"request {i} can never fit ({len(prompts[i])}+{max_new})")
    out: dict[int, list[int]] = {i: [] for i in range(len(prompts))}
    ttft: dict[int, float] = {}
    t0 = time.perf_counter()
    while waiting or engine.active:
        while waiting and engine.can_admit(len(prompts[waiting[0]]), max_new):
            i = waiting.popleft()
            engine.submit(str(i), prompts[i], max_new)
        for rid, token, done in engine.step():
            i = int(rid)
            if not out[i]:
                ttft[i] = time.perf_counter() - t0
            out[i].append(token)
            if on_token is not None:
                on_token(i, token, done)
    return out, ttft


def main(argv=None) -> int:
    from dora_tpu_torch.models.hf import qwen2

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--prompts", required=True,
                    help="JSON file: a list of token-id lists")
    ap.add_argument("--max-new", type=int,
                    default=int(os.environ.get("DORA_MAX_NEW_TOKENS", "32")))
    ap.add_argument("--random-config", choices=sorted(qwen2.CONFIGS),
                    help="seeded random weights at this config (no checkpoint)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    max_seq = int(os.environ.get("DORA_MAX_SEQ", "2048"))
    if args.random_config:
        cfg = qwen2.CONFIGS[args.random_config](max_seq=max_seq)
        params = qwen2.random_params(cfg, seed=args.seed, device=args.device)
    else:
        path = os.environ.get("DORA_HF_CHECKPOINT")
        if not path:
            ap.error("set DORA_HF_CHECKPOINT or pass --random-config")
        cfg, params = qwen2.load(path, max_seq=max_seq, device=args.device)
    params = qwen2.quantize_decode(params, cfg)

    with open(args.prompts) as f:
        prompts = [[int(t) for t in p] for p in json.load(f)]
    engine = make_engine(params, cfg, device=args.device)
    out, ttft = serve_prompts(engine, prompts, args.max_new)
    for i in range(len(prompts)):
        print(json.dumps({"id": i, "ttft_s": ttft.get(i), "tokens": out[i]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
