"""The serving A/B legs on the port: counterpart of dora_tpu/tools/bench_serving.py.

Each leg prints one JSON line with the keys of the JAX tool's line, where
``backend`` becomes ``device`` (the card's name and power limit, as
``nvidia-smi`` gives them, or ``"cpu"``), and every leg adds ``launches``
(the hand-written kernels' launches over the leg, by name) and
``plain_calls`` (calls of their plain versions; on the card none):

* default: the paged engine against the dense engine at 4 streams (both 4
  slots) and at 16 (the paged engine's 16 slots in the dense engine's
  4-slot KV footprint; the dense engine queues 12), tokens/s, wall and
  TTFT;
* ``--multistep``: the decode window's K in {1, 4, 8, 16} at 4 and 16
  streams, host round trips (dispatches + fetches) a token beside tokens/s;
* ``--trace-ab``: the 16-stream paged run with the serving tracer and
  metrics attached, tracing off against on, trials interleaved;
* ``--quant-ab``: fp KV, int8 KV and int8 KV + int4 weights on one 4-stream
  workload (greedy agreement against the fp leg), the streams each KV dtype
  admits into one pool byte budget through ``can_admit`` / ``submit``, and
  speculation's acceptance on fp and int8 KV;
* ``--spec-ab``, ``--lora-ab``, ``--profiling-ab``, ``--fleet-digest-ab``,
  ``--qos-soak``, ``--prefix-ab``: the weight-free stub engine
  (models/batch_engine.make_stub_paged_engine) through the engine's own
  scheduler, ``llm_server.serve``, the fleet digest and the device plane.
  Where the JAX legs count XLA compiles, these count graph captures.

Model legs: ``DORA_HF_CHECKPOINT`` when set (``DORA_MAX_SEQ``, default 512);
else on the CPU the tiny random Qwen2 the JAX tool builds, at its sizes;
else on the card a Qwen2-1.5B-width model (28 layers) with seeded random
weights, at the JAX tool's checkpoint sizes (page 16, chunk 64, 64-token
prompts). Weights are int8 (``quantize_decode``) in every case. On the card
the paged windows and the dense step run as CUDA graphs, each captured in
a leg's warmup; a measured run that captures raises.

Usage::

    python -m dora_tpu_torch.tools.bench_serving [--device cpu]
        [--multistep | --trace-ab | --quant-ab | --spec-ab | --lora-ab |
         --profiling-ab | --fleet-digest-ab | --qos-soak | --prefix-ab]

Runs on the card (cuda) unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time
from collections import deque


def _tiny_checkpoint(tmp: str) -> str:
    import torch
    from transformers import Qwen2Config, Qwen2ForCausalLM

    config = Qwen2Config(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, rope_theta=10000.0,
        rms_norm_eps=1e-6, tie_word_embeddings=False,
        attn_implementation="eager",
    )
    torch.manual_seed(0)
    Qwen2ForCausalLM(config).eval().save_pretrained(tmp, safe_serialization=True)
    return tmp


def _model(dev, tiny_max_seq: int):
    """(cfg, f32 params, model name, real sizes?) of a model leg."""
    from dora_tpu_torch.models.hf import qwen2

    path = os.environ.get("DORA_HF_CHECKPOINT")
    max_seq = int(os.environ.get("DORA_MAX_SEQ", "512"))
    if path:
        cfg, params = qwen2.load(path, max_seq=max_seq, device=dev)
        return cfg, params, "checkpoint", True
    if dev.type == "cpu":
        with tempfile.TemporaryDirectory(prefix="bench-serving-") as tmp:
            cfg, params = qwen2.load(_tiny_checkpoint(tmp), max_seq=tiny_max_seq, device=dev)
        return cfg, params, "tiny-random", False
    cfg = qwen2.Qwen2Config.qwen2_1_5b(max_seq=max_seq)
    return (cfg, qwen2.random_params(cfg, seed=0, std=0.02, device=dev),
            "seeded-qwen2-1.5b-width", True)


def _prompts(rng, cfg, plen: int):
    return lambda n: [rng.integers(0, cfg.vocab, size=plen).tolist() for _ in range(n)]


def _pool_bytes(tree) -> int:
    """Bytes of every tensor in a (nested dict) pool or cache tree."""
    if isinstance(tree, dict):
        return sum(_pool_bytes(v) for v in tree.values())
    return int(tree.nbytes)


class _NoCapture:
    """Holds a measured run to the warmup's graph captures: leaving the
    block with more captures than entering it raises."""

    def __init__(self, *engines):
        self.engines = engines

    def __enter__(self):
        self.before = [e.graph_captures for e in self.engines]
        return self

    def __exit__(self, exc_type, *exc):
        after = [e.graph_captures for e in self.engines]
        if exc_type is None and after != self.before:
            raise RuntimeError(f"a measured run captured a window graph ({self.before} -> "
                               f"{after}): its key was not warmed up")


def _serve(engine, prompts, max_new: int):
    """Push every request at t0, drain to completion. Returns
    (tokens_emitted, wall_s, ttft_s per request); TTFT includes queue
    wait, which an engine that cannot admit pays."""
    backlog = deque(enumerate(prompts))
    t0 = time.perf_counter()
    ttft: dict[int, float] = {}
    tokens = 0
    active_keys: set[int] = set()
    while backlog or active_keys:
        while backlog and engine.can_admit(len(backlog[0][1]), max_new):
            rid, ids = backlog.popleft()
            active_keys.add(rid)
            res = engine.submit(str(rid), ids, max_new)
            if res is not None:  # dense: first token is synchronous
                tokens += 1
                ttft.setdefault(rid, time.perf_counter() - t0)
                if res[1]:
                    active_keys.discard(rid)
        for key, _token, done in engine.step():
            rid = int(key)
            tokens += 1
            ttft.setdefault(rid, time.perf_counter() - t0)
            if done:
                active_keys.discard(rid)
    return tokens, time.perf_counter() - t0, list(ttft.values())


def _stats(tokens: int, wall: float, ttfts: list[float]) -> dict:
    ordered = sorted(ttfts)
    return {
        "decode_tok_s": round(tokens / wall, 1) if wall > 0 else None,
        "wall_s": round(wall, 3),
        "tokens": tokens,
        "ttft_p50_ms": round(statistics.median(ordered) * 1e3, 1),
        "ttft_p99_ms": round(ordered[min(len(ordered) - 1, int(len(ordered) * 0.99))] * 1e3, 1),
    }


def _multistep_sweep(dev, device: str) -> dict:
    """K sweep of the decode window: host round trips an emitted token and
    tokens/s at K in {1, 4, 8, 16}, 4 and 16 streams, on a decode-heavy
    workload (short prompts, long generations). Warmup runs are short (the
    shapes, hence the captures, do not depend on max_new); measured runs
    read counter deltas."""
    import numpy as np

    from dora_tpu_torch.models.hf import qwen2

    cfg, params, name, real = _model(dev, tiny_max_seq=128)
    if real:
        page_size, chunk, plen = 16, 64, 64
        max_new = {4: min(256, cfg.max_seq - plen), 16: 32}
    else:
        page_size, chunk, plen = 8, 8, 4
        max_new = {4: 120, 16: 24}
    params = qwen2.quantize_decode(params, cfg)
    prompts = _prompts(np.random.default_rng(3), cfg, plen)

    out: dict = {
        "device": device,
        "model": name,
        "plen": plen,
        "max_new": {str(s): m for s, m in max_new.items()},
        "k_sweep": {},
    }
    per_k: dict[int, dict] = {}
    for streams in (4, 16):
        leg: dict = {}
        for k in (1, 4, 8, 16):
            engine = qwen2.make_paged_engine(params, cfg, max_slots=streams,
                                             page_size=page_size, chunk=chunk, window=k,
                                             device=dev)
            _serve(engine, prompts(streams), 4)  # warmup: the window's capture
            d0, f0 = engine.dispatches, engine.fetches
            with _NoCapture(engine):
                tokens, wall, ttfts = _serve(engine, prompts(streams), max_new[streams])
            trips = (engine.dispatches - d0) + (engine.fetches - f0)
            stats = _stats(tokens, wall, ttfts)
            stats["round_trips"] = trips
            stats["rt_per_token"] = round(trips / tokens, 4)
            stats["tokens_per_dispatch"] = round(tokens / (engine.dispatches - d0), 2)
            leg[f"k{k}"] = stats
            del engine
        out["k_sweep"][f"streams{streams}"] = leg
        per_k[streams] = leg
    s4 = per_k[4]
    out["k8_vs_k1_rt_reduction"] = round(s4["k1"]["rt_per_token"] / s4["k8"]["rt_per_token"], 2)
    return out


def _trace_ab(dev, device: str) -> dict:
    """Serving-span instrumentation overhead: the 16-stream paged run with
    the tracer and serving metrics attached, tracing off against on, trials
    interleaved. Both sides carry the objects; the off side pays what
    serving pays without ``DORA_TRACING=1``, so ``overhead_pct`` isolates
    the span records."""
    import numpy as np

    from dora_tpu_torch import telemetry
    from dora_tpu_torch.metrics import ServingMetrics
    from dora_tpu_torch.models.hf import qwen2

    cfg, params, name, real = _model(dev, tiny_max_seq=64)
    if real:
        page_size, chunk, plen, max_new = 16, 64, 64, 32
    else:
        page_size, chunk, plen, max_new = 8, 8, 4, 8
    params = qwen2.quantize_decode(params, cfg)
    prompts = _prompts(np.random.default_rng(7), cfg, plen)

    engine = qwen2.make_paged_engine(params, cfg, max_slots=16, page_size=page_size,
                                     chunk=chunk, device=dev)
    engine.serving_metrics = ServingMetrics("paged")
    tracer = telemetry.ServingTracer()
    engine.tracer = tracer
    _serve(engine, prompts(16), max_new)  # warmup: the window's capture
    trials = int(os.environ.get("DORA_BENCH_TRIALS", "5"))
    walls: dict[str, list[float]] = {"off": [], "on": []}
    span_events = 0
    try:
        with _NoCapture(engine):
            for _ in range(trials):
                for mode in ("off", "on"):
                    on = mode == "on"
                    telemetry.TRACING.active = on
                    telemetry.FLIGHT.enabled = on
                    telemetry.FLIGHT.clear()
                    for i in range(16):
                        tracer.begin(str(i))
                    _tokens, wall, _ = _serve(engine, prompts(16), max_new)
                    for i in range(16):
                        tracer.finish(str(i))
                    if on:
                        span_events = len(telemetry.FLIGHT.events())
                    walls[mode].append(wall)
    finally:
        telemetry.TRACING.active = False
        telemetry.FLIGHT.enabled = False
    off_w = statistics.median(walls["off"])
    on_w = statistics.median(walls["on"])
    return {
        "device": device,
        "model": name,
        "off_wall_s": round(off_w, 4),
        "on_wall_s": round(on_w, 4),
        "overhead_pct": round((on_w - off_w) / off_w * 100, 2) if off_w else None,
        "span_events_per_run": span_events,
        "trials": trials,
    }


def _serve_tokens(engine, prompts, max_new: int):
    """:func:`_serve` for paged engines, keeping each stream's emitted
    tokens (the quant A/B compares greedy tokens per position)."""
    backlog = deque(enumerate(prompts))
    seqs: dict[int, list[int]] = {i: [] for i in range(len(prompts))}
    active: set[int] = set()
    t0 = time.perf_counter()
    ttft: dict[int, float] = {}
    while backlog or active:
        while backlog and engine.can_admit(len(backlog[0][1]), max_new):
            rid, ids = backlog.popleft()
            active.add(rid)
            engine.submit(str(rid), ids, max_new)
        for key, token, done in engine.step():
            rid = int(key)
            seqs[rid].append(int(token))
            ttft.setdefault(rid, time.perf_counter() - t0)
            if done:
                active.discard(rid)
    return seqs, time.perf_counter() - t0, list(ttft.values())


def _quant_ab(dev, device: str) -> dict:
    """Quantized serving: tokens/s and greedy agreement for fp-KV, int8-KV
    and int8-KV + int4-weight engines on one prompt set, then a capacity leg
    counting concurrent admissions into the SAME pool byte budget (the int8
    pool is resized into the fp pool's bytes by ``make_paged_engine``, scale
    planes included), then speculation's acceptance on fp and int8 KV.
    Agreement is the share of positions whose token equals the fp leg's;
    ``first_parting`` gives, per stream, where the int8-KV leg first parts
    from the fp leg, its prompt, the tokens before it and the two tokens
    there (on the card, chip_smoke.py holds such partings to near-ties)."""
    import numpy as np

    from dora_tpu_torch.metrics import ServingMetrics
    from dora_tpu_torch.models.hf import qwen2

    cfg, params, name, real = _model(dev, tiny_max_seq=64)
    if real:
        page_size, chunk, plen, max_new = 16, 64, 64, 64
    else:
        page_size, chunk, plen, max_new = 8, 8, 4, 24
    params8 = qwen2.quantize_decode(params, cfg)
    prev = os.environ.get("DORA_WEIGHT_BITS")
    os.environ["DORA_WEIGHT_BITS"] = "4"
    try:
        params4 = qwen2.quantize_decode(params, cfg)
    finally:
        if prev is None:
            del os.environ["DORA_WEIGHT_BITS"]
        else:
            os.environ["DORA_WEIGHT_BITS"] = prev
    del params
    rng = np.random.default_rng(11)
    work = [rng.integers(0, cfg.vocab, size=plen).tolist() for _ in range(4)]

    out: dict = {
        "device": device,
        "model": name,
        "plen": plen,
        "max_new": max_new,
        "streams": 4,
    }
    seqs_by_leg: dict[str, dict[int, list[int]]] = {}
    for leg, leg_params, kv8 in (("fp", params8, False), ("kv_int8", params8, True),
                                 ("kv_int8_w4", params4, True)):
        engine = qwen2.make_paged_engine(leg_params, cfg, max_slots=4, page_size=page_size,
                                         chunk=chunk, kv_int8=kv8, device=dev)
        _serve_tokens(engine, work, 4)  # warmup: the window's capture
        with _NoCapture(engine):
            seqs, wall, ttfts = _serve_tokens(engine, work, max_new)
        tokens = sum(len(s) for s in seqs.values())
        stats = _stats(tokens, wall, ttfts)
        stats["kv_dtype"] = engine.kv_dtype
        stats["pool_bytes"] = _pool_bytes(engine.pools)
        out[leg] = stats
        seqs_by_leg[leg] = seqs
        del engine
    del params4

    def agree(ref: dict, other: dict):
        total = match = 0
        for rid, ref_seq in ref.items():
            for a, b in zip(ref_seq, other.get(rid, [])):
                total += 1
                match += int(a == b)
        return round(match / total, 4) if total else None

    out["greedy_agreement_vs_fp"] = {
        "kv_int8": agree(seqs_by_leg["fp"], seqs_by_leg["kv_int8"]),
        "kv_int8_w4": agree(seqs_by_leg["fp"], seqs_by_leg["kv_int8_w4"]),
    }
    partings = {}
    for rid, ref_seq in seqs_by_leg["fp"].items():
        got = seqs_by_leg["kv_int8"][rid]
        at = next((t for t, (a, b) in enumerate(zip(got, ref_seq)) if a != b), None)
        if at is not None:
            partings[str(rid)] = {"at": at, "prompt": work[rid], "before": got[:at],
                                  "kv_int8": got[at], "fp": ref_seq[at]}
    out["first_parting"] = partings

    # Capacity: both engines get the default pool byte budget; streams are
    # admitted through the real can_admit / submit page grants until the
    # pool refuses. No step runs: admission is host bookkeeping.
    cap: dict[str, dict] = {}
    for leg, kv8 in (("fp", False), ("int8", True)):
        engine = qwen2.make_paged_engine(params8, cfg, max_slots=512, page_size=page_size,
                                         chunk=chunk, kv_int8=kv8, device=dev)
        n = 0
        while n < 512 and engine.can_admit(plen, max_new):
            engine.submit(f"cap{n}", work[0], max_new)
            n += 1
        cap[leg] = {
            "streams": n,
            "pool_bytes": _pool_bytes(engine.pools),
            "usable_pages": engine.allocator.num_pages - 1,
        }
        del engine
    out["capacity"] = {
        "fp": cap["fp"],
        "int8": cap["int8"],
        "pool_budget_ratio": round(cap["int8"]["pool_bytes"] / cap["fp"]["pool_bytes"], 3),
        "int8_capacity_ratio": round(cap["int8"]["streams"] / cap["fp"]["streams"], 2),
    }

    # Speculation's acceptance under int8 KV against fp: a near-tie that
    # flips under rounding shows as a rejected draft.
    spec: dict = {}
    for leg, kv8 in (("fp", False), ("int8", True)):
        engine = qwen2.make_paged_engine(params8, cfg, max_slots=4, page_size=page_size,
                                         chunk=chunk, kv_int8=kv8, spec_k=2, device=dev)
        _serve_tokens(engine, work, 4)  # warmup: the window's capture
        engine.serving_metrics = ServingMetrics(engine="paged")
        with _NoCapture(engine):
            _serve_tokens(engine, work, max_new)
        sm = engine.serving_metrics
        spec[f"acceptance_{leg}"] = (
            round(sm.spec_accepted / sm.spec_drafted, 4) if sm.spec_drafted else None)
        spec[f"drafted_{leg}"] = sm.spec_drafted
        del engine
    spec["spec_acceptance"] = spec["acceptance_int8"]
    out["spec"] = spec
    return out


def _ab(dev, device: str) -> dict:
    """The default leg: paged against dense at 4 and 16 streams. The real
    sizes put 64-token prompts and 32 new tokens inside the default (dense
    4-slot footprint) pool; the tiny model shrinks everything to stay
    admissible at 16 streams under the same footprint rule."""
    import numpy as np

    from dora_tpu_torch.models.hf import qwen2

    cfg, params, name, real = _model(dev, tiny_max_seq=64)
    if real:
        page_size, chunk, plen, max_new = 16, 64, 64, 32
    else:
        page_size, chunk, plen, max_new = 8, 8, 4, 4
    params = qwen2.quantize_decode(params, cfg)
    prompts = _prompts(np.random.default_rng(0), cfg, plen)

    out: dict = {"device": device, "model": name, "plen": plen, "max_new": max_new}
    dense4 = qwen2.make_batch_engine(params, cfg, max_slots=4, device=dev)
    paged4 = qwen2.make_paged_engine(params, cfg, max_slots=4, page_size=page_size,
                                     chunk=chunk, device=dev)
    paged16 = qwen2.make_paged_engine(params, cfg, max_slots=16, page_size=page_size,
                                      chunk=chunk, device=dev)

    # Warmup: each engine through the full workload shape once, so the
    # measured runs capture nothing.
    _serve(dense4, prompts(4), max_new)
    _serve(paged4, prompts(4), max_new)
    _serve(paged16, prompts(16), max_new)

    with _NoCapture(dense4, paged4, paged16):
        p4 = _stats(*_serve(paged4, prompts(4), max_new))
        d4 = _stats(*_serve(dense4, prompts(4), max_new))
        p16 = _stats(*_serve(paged16, prompts(16), max_new))
        d16 = _stats(*_serve(dense4, prompts(16), max_new))
    out["streams4"] = {
        "paged": p4,
        "dense": d4,
        "paged_vs_dense": (round(p4["decode_tok_s"] / d4["decode_tok_s"], 3)
                           if p4["decode_tok_s"] and d4["decode_tok_s"] else None),
    }
    out["streams16"] = {
        "paged_16slot": p16,
        "dense_4slot_queued": d16,
        "paged_pool_bytes": _pool_bytes(paged16.pools),
        "dense_4slot_cache_bytes": _pool_bytes(qwen2.init_cache(cfg, 4, device=dev)),
        "wall_speedup": (round(d16["wall_s"] / p16["wall_s"], 2)
                         if p16["wall_s"] and d16["wall_s"] else None),
    }
    return out


def _lora_ab(dev, device: str) -> dict:
    """Multi-tenant LoRA: the aggregate tokens/s of ONE paged engine serving
    N adapter tenants against N engines splitting the same budget (pages
    and slots divided N ways) run back to back, on the stub engine with a
    2 ms host sleep a window standing in for a weight-streaming-bound decode
    (flat in active slots, which the shared engine amortizes). A churn leg
    rides along: 6 tenants through 2 resident slots, counting graph captures
    after the window shapes are warm (the adapter slot is data, so churn
    must capture nothing)."""
    from dora_tpu_torch.models.batch_engine import make_stub_paged_engine

    tenants, per_tenant, max_new = 4, 2, 64
    max_seq, page_size, chunk, pages = 128, 8, 16, 64
    step_cost_s = 0.002
    names = [f"tenant-{i}" for i in range(tenants)]
    prompts = {n: [[3 + i], [11 + i]] for i, n in enumerate(names)}

    def serve_tenants(engine, work):
        """(key, ids, adapter) triples, pushed at t0, drained."""
        backlog = deque(work)
        active: set[str] = set()
        tokens = 0
        t0 = time.perf_counter()
        while backlog or active:
            while backlog and engine.can_admit(len(backlog[0][1]), max_new, backlog[0][2]):
                key, ids, ad = backlog.popleft()
                active.add(key)
                engine.submit(key, ids, max_new, adapter=ad)
            for key, _tok, done in engine.step():
                tokens += 1
                if done:
                    active.discard(key)
        return tokens, time.perf_counter() - t0

    out: dict = {
        "device": device,
        "tenants": tenants,
        "streams_per_tenant": per_tenant,
        "max_new": max_new,
        "pool_pages": pages,
    }
    shared = make_stub_paged_engine(
        max_slots=tenants * per_tenant, max_seq=max_seq, page_size=page_size, chunk=chunk,
        num_pages=pages, lora_max_resident=tenants, tick_sleep_s=step_cost_s, device=dev)
    work = [(f"{n}/{j}", ids, n) for n in names for j, ids in enumerate(prompts[n])]
    serve_tenants(shared, work)  # warmup: the window's capture
    with _NoCapture(shared):
        tokens, wall = serve_tenants(shared, work)
    out["shared"] = {"tokens": tokens, "wall_s": round(wall, 3), "tok_s": round(tokens / wall, 1)}

    sep_tokens = sep_wall = 0.0
    engines = [
        make_stub_paged_engine(max_slots=per_tenant, max_seq=max_seq, page_size=page_size,
                               chunk=chunk, num_pages=max(2, pages // tenants),
                               tick_sleep_s=step_cost_s, device=dev)
        for _ in names
    ]
    for engine, n in zip(engines, names):
        serve_tenants(engine, [(f"{n}/w{j}", ids, None) for j, ids in enumerate(prompts[n])])
    with _NoCapture(*engines):
        for engine, n in zip(engines, names):
            t, w = serve_tenants(engine, [(f"{n}/{j}", ids, None)
                                          for j, ids in enumerate(prompts[n])])
            sep_tokens += t
            sep_wall += w
    out["separate"] = {
        "tokens": int(sep_tokens),
        "wall_s": round(sep_wall, 3),
        "tok_s": round(sep_tokens / sep_wall, 1),
        "pages_each": max(2, pages // tenants),
    }
    out["lora_aggregate_ratio"] = round(out["shared"]["tok_s"] / out["separate"]["tok_s"], 2)

    churn = make_stub_paged_engine(max_slots=2, max_seq=max_seq, page_size=page_size,
                                   chunk=chunk, num_pages=pages, lora_max_resident=2,
                                   device=dev)
    churn_names = [f"churn-{i}" for i in range(6)]
    serve_tenants(churn, [(f"warm/{n}", [5], n) for n in churn_names[:2]])  # warmup
    c0 = churn.graph_captures
    for cycle in range(2):
        for n in churn_names:
            serve_tenants(churn, [(f"{cycle}/{n}", [7], n)])
    out["churn"] = {
        "adapters": len(churn_names),
        "resident_budget": 2,
        "loads": churn.lora.loads,
        "evictions": churn.lora.evictions,
        "steady_state_compiles": churn.graph_captures - c0,
    }
    return out


def _spec_ab(dev, device: str) -> dict:
    """Speculative decoding: acceptance and tokens per dispatch, spec_k in
    {0, 2, 4} by window K in {1, 8}, on the stub engine's repetitive rule
    (the period-4 cycle: drafts come true) and its random rule (the affine
    full-period rule: ~0 % acceptance, every dispatch pays the k + 1-row
    verify for one token). Counter deltas around the measured run."""
    from dora_tpu_torch.metrics import ServingMetrics
    from dora_tpu_torch.models.batch_engine import make_stub_paged_engine

    max_seq, page_size, chunk, max_new, streams = 128, 8, 16, 96, 4
    prompts = [[5], [6], [7], [8]]
    out: dict = {"device": device, "max_new": max_new, "streams": streams, "legs": {}}
    for leg, cycle in (("repetitive", 4), ("random", None)):
        leg_out: dict = {}
        for K in (1, 8):
            for k in (0, 2, 4):
                engine = make_stub_paged_engine(max_slots=streams, max_seq=max_seq,
                                                page_size=page_size, chunk=chunk, window=K,
                                                spec_k=k, cycle=cycle, device=dev)
                _serve(engine, prompts, 4)  # warmup: the window's capture
                engine.serving_metrics = ServingMetrics(engine="paged")
                d0 = engine.dispatches
                with _NoCapture(engine):
                    tokens, _wall, _ = _serve(engine, prompts, max_new)
                sm = engine.serving_metrics
                leg_out[f"k{k}_K{K}"] = {
                    "tokens": tokens,
                    "dispatches": engine.dispatches - d0,
                    "tokens_per_dispatch": round(tokens / (engine.dispatches - d0), 2),
                    "acceptance": (round(sm.spec_accepted / sm.spec_drafted, 3)
                                   if sm.spec_drafted else None),
                }
        out["legs"][leg] = leg_out
    rep, rnd = out["legs"]["repetitive"], out["legs"]["random"]
    out["rep_k4_vs_k0_tpd_at_k8"] = round(
        rep["k4_K8"]["tokens_per_dispatch"] / rep["k0_K8"]["tokens_per_dispatch"], 2)
    out["rand_k4_vs_k0_tpd_at_k8"] = round(
        rnd["k4_K8"]["tokens_per_dispatch"] / rnd["k0_K8"]["tokens_per_dispatch"], 2)
    return out


def _paired_overhead(walls: dict) -> float:
    """Median of the per-trial on / off ratios, as a percentage over 1:
    slow drift hits both halves of a pair and divides out."""
    ratios = [on / off for off, on in zip(walls["off"], walls["on"]) if off > 0]
    return (statistics.median(ratios) - 1.0) * 100.0 if ratios else 0.0


def _profiling_ab(dev, device: str) -> dict:
    """The device plane (per-window dispatch / compute / fetch attribution
    and the FLOPs ledger) on against off at 16 streams on ONE stub engine,
    ``device_monitor`` toggled between serves, pair order alternating; the
    estimate is the median of per-trial paired ratios. Gate: <= 3 %."""
    from dora_tpu_torch.models.batch_engine import make_stub_paged_engine

    max_seq, page_size, chunk, max_new, streams = 256, 8, 16, 192, 16
    prompts = [[i + 5] for i in range(streams)]
    trials = int(os.environ.get("DORA_BENCH_TRIALS", "14"))
    engine = make_stub_paged_engine(max_slots=streams, max_seq=max_seq, page_size=page_size,
                                    chunk=chunk, window=8, device=dev)
    _serve(engine, prompts, 4)  # warmup: the window's capture
    walls: dict[str, list[float]] = {"off": [], "on": []}
    with _NoCapture(engine):
        for i in range(trials):
            for mode in (("off", "on") if i % 2 == 0 else ("on", "off")):
                engine.device_monitor = mode == "on"
                _, wall, _ = _serve(engine, prompts, max_new)
                walls[mode].append(wall)
    engine.device_monitor = True
    overhead = _paired_overhead(walls)
    return {
        "device": device,
        "streams": streams,
        "max_new": max_new,
        "trials": trials,
        "monitor_off_wall_s": round(statistics.median(walls["off"]), 4),
        "monitor_on_wall_s": round(statistics.median(walls["on"]), 4),
        "overhead_pct": round(overhead, 2),
        "gate_pct": 3.0,
        "pass": overhead <= 3.0,
    }


def _serve_ticked(engine, prompts, max_new: int, tick) -> tuple[int, float]:
    """The :func:`_serve` drain loop with a ``tick()`` each iteration, where
    the serving loop ticks its fleet digest publisher. Both A/B arms run
    this loop, so only the publish work differs."""
    backlog = deque(enumerate(prompts))
    t0 = time.perf_counter()
    tokens = 0
    active_keys: set[int] = set()
    while backlog or active_keys:
        tick()
        while backlog and engine.can_admit(len(backlog[0][1]), max_new):
            rid, ids = backlog.popleft()
            active_keys.add(rid)
            res = engine.submit(str(rid), ids, max_new)
            if res is not None:
                tokens += 1
                if res[1]:
                    active_keys.discard(rid)
        for key, _token, done in engine.step():
            tokens += 1
            if done:
                active_keys.discard(int(key))
    return tokens, time.perf_counter() - t0


def _fleet_digest_ab(dev, device: str) -> dict:
    """The fleet digest (fleet.build_digest: the radix-tree top-N walk,
    fits()-derived capacity, fingerprint) published every 0.5 s (4x the
    default cadence) against off, on the 16-stream stub leg with the prefix
    cache on, paired-ratio trials as :func:`_profiling_ab`. Gate: <= 3 %."""
    from dora_tpu_torch import fleet
    from dora_tpu_torch.models.batch_engine import make_stub_paged_engine

    max_seq, page_size, chunk, max_new, streams = 256, 8, 16, 192, 16
    cadence_s = 0.5
    prompts = [[i + 5] for i in range(streams)]
    trials = int(os.environ.get("DORA_BENCH_TRIALS", "14"))
    engine = make_stub_paged_engine(max_slots=streams, max_seq=max_seq, page_size=page_size,
                                    chunk=chunk, window=8, prefix_cache=True, device=dev)
    _serve(engine, prompts, 4)  # warmup: the capture, and a populated radix tree

    class _Sink:
        def __init__(self):
            self.digests = 0

        def report_engine_state(self, digest):
            self.digests += 1

    published = 0
    walls: dict[str, list[float]] = {"off": [], "on": []}
    with _NoCapture(engine):
        for i in range(trials):
            for mode in (("off", "on") if i % 2 == 0 else ("on", "off")):
                sink = _Sink()
                pub = fleet.DigestPublisher(sink, engine, model_id="stub",
                                            interval_s=cadence_s if mode == "on" else 0)
                _, wall = _serve_ticked(engine, prompts, max_new, pub.tick)
                walls[mode].append(wall)
                published += sink.digests
    overhead = _paired_overhead(walls)
    return {
        "device": device,
        "streams": streams,
        "max_new": max_new,
        "trials": trials,
        "cadence_s": cadence_s,
        "digests_published": published,
        "digest_off_wall_s": round(statistics.median(walls["off"]), 4),
        "digest_on_wall_s": round(statistics.median(walls["on"]), 4),
        "overhead_pct": round(overhead, 2),
        "gate_pct": 3.0,
        "pass": overhead <= 3.0,
    }


class _OpenLoopNode:
    """Node fake feeding serve() a pre-scheduled open-loop arrival trace:
    recv() releases an event once its arrival time has passed, so arrivals
    do not slow down when the engine backs up (a closed loop would throttle
    itself and hide the overload)."""

    def __init__(self, schedule):
        #: [(t_offset_s, event), ...] sorted by offset
        self._schedule = deque(schedule)
        self._t0 = time.perf_counter()
        self.stream_ended = False
        self.sent: list[tuple[float, dict]] = []

    def now(self) -> float:
        return time.perf_counter() - self._t0

    def recv(self, timeout=None):
        if not self._schedule:
            self.stream_ended = True
            return None
        if self.now() >= self._schedule[0][0]:
            return self._schedule.popleft()[1]
        return None

    def send_output(self, output_id, value, metadata=None):
        self.sent.append((self.now(), dict(metadata or {})))

    def report_serving(self, snapshot):
        pass

    def close(self):
        pass


def _pct(vals, q: float, digits: int):
    if not vals:
        return None
    o = sorted(vals)
    return round(o[min(len(o) - 1, int(len(o) * q))] * 1e3, digits)


def _qos_soak(dev, device: str) -> dict:
    """Mixed-class Poisson overload through serve()'s admission path on the
    stub engine, QoS shaping on against off over one seeded arrival trace:
    per-class TTFT p50 / p99, sheds, preemptions. The off leg drops the
    class tags and the shaping env (the single-class FIFO). Headline:
    ``interactive_p99_on_vs_off`` < 1; every stream must finish."""
    import numpy as np

    from dora_tpu_torch.metrics import ServingMetrics
    from dora_tpu_torch.models.batch_engine import make_stub_paged_engine
    from dora_tpu_torch.nodehub.llm_server import serve

    streams = int(os.environ.get("DORA_BENCH_QOS_STREAMS", "1200"))
    max_new, tick_sleep = 8, 0.0008
    # One prefill chunk a step bounds admission to ~1 / window wall streams
    # a second; the arrival rate doubles it: a sustained overload.
    rate = 2.0 / (4 * tick_sleep)
    rng = np.random.default_rng(7)
    gaps = rng.exponential(1.0 / rate, size=streams)
    classes = rng.choice(["interactive", "standard", "batch"], size=streams,
                         p=[0.25, 0.35, 0.40])
    arrivals = []
    t = 0.0
    for n in range(streams):
        t += float(gaps[n])
        arrivals.append((t, f"q{n}", str(classes[n])))

    qos_env = {
        "DORA_QOS_PREEMPT": "1",
        "DORA_QOS_SHED_WAIT_MS": "1500",
        "DORA_QOS_DEPTH_BATCH": "256",
    }

    def leg(shaped: bool) -> dict:
        saved = {k: os.environ.pop(k, None) for k in qos_env}
        if shaped:
            os.environ.update(qos_env)
        try:
            engine = make_stub_paged_engine(max_slots=8, max_seq=64, page_size=8, chunk=16,
                                            window=4, tick_sleep_s=tick_sleep, device=dev)
            schedule = [
                (at, {
                    "type": "INPUT",
                    "metadata": {
                        "request_id": rid,
                        "max_new_tokens": max_new,
                        **({"qos_class": cls} if shaped else {}),
                    },
                    "value": f"prompt {rid}".encode(),
                })
                for at, rid, cls in arrivals
            ]
            node = _OpenLoopNode(schedule)
            metrics = ServingMetrics(engine="paged")
            t0 = time.perf_counter()
            serve(node, engine, metrics,
                  encode=lambda text: [ord(ch) % 97 + 1 for ch in text],
                  decode_one=lambda tok: f" t{tok}", max_new_cap=max_new)
            wall = time.perf_counter() - t0
            by_rid: dict[str, dict] = {}
            for ts, meta in node.sent:
                rid = meta.get("request_id")
                if rid is None:
                    continue
                s = by_rid.setdefault(rid, {"t0": ts, "finish": None})
                if meta.get("done"):
                    s["finish"] = meta.get("finish")
            ttft: dict[str, list[float]] = {"interactive": [], "standard": [], "batch": []}
            finishes: dict[str, int] = {}
            for at, rid, cls in arrivals:
                s = by_rid.get(rid)
                if s is None or not s["finish"]:
                    raise RuntimeError(f"stream {rid} silently lost")
                finishes[s["finish"]] = finishes.get(s["finish"], 0) + 1
                if s["finish"] in ("stop", "length"):
                    ttft[cls].append(s["t0"] - at)
            return {
                "wall_s": round(wall, 2),
                "finishes": finishes,
                "shed": metrics.shed,
                "preempted": metrics.preempted,
                "resumed": metrics.resumed,
                "ttft_ms": {
                    cls: {"n": len(vals), "p50": _pct(vals, 0.50, 1), "p99": _pct(vals, 0.99, 1)}
                    for cls, vals in ttft.items()
                },
            }
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    on, off = leg(shaped=True), leg(shaped=False)
    p99_on = on["ttft_ms"]["interactive"]["p99"]
    p99_off = off["ttft_ms"]["interactive"]["p99"]
    return {
        "device": device,
        "streams": streams,
        "arrival_rate_per_s": round(rate, 1),
        "max_new": max_new,
        "qos_on": on,
        "qos_off": off,
        "interactive_p99_on_vs_off": (round(p99_on / p99_off, 3)
                                      if p99_on is not None and p99_off else None),
    }


def _prefix_ab(dev, device: str) -> dict:
    """The shared-prefix cache at admission: a Zipf-popular template
    workload (few hot system prompts, unique tails) replayed open-loop on
    the stub engine, cache on against off over one seeded trace. A 2 ms
    host sleep a prefill chunk makes TTFT follow the chunks run, so a hit
    shows in first-token latency. Headline: ``hit_p50_on_vs_off``, the hit
    requests' TTFT p50 against the same requests uncached (<= 0.5)."""
    import numpy as np

    from dora_tpu_torch.metrics import ServingMetrics
    from dora_tpu_torch.models.batch_engine import make_stub_paged_engine
    from dora_tpu_torch.nodehub.llm_server import serve

    streams = int(os.environ.get("DORA_BENCH_PREFIX_STREAMS", "120"))
    templates, prefix_len, tail_len = 8, 64, 8
    max_new, chunk_sleep = 8, 0.002
    rng = np.random.default_rng(11)
    weights = 1.0 / np.arange(1, templates + 1) ** 1.2
    weights /= weights.sum()
    picks = rng.choice(templates, size=streams, p=weights)
    gaps = rng.exponential(0.015, size=streams)
    tmpl_ids = [[int(t) for t in rng.integers(1, 90, size=prefix_len)]
                for _ in range(templates)]
    arrivals = []
    t = 0.0
    for n in range(streams):
        t += float(gaps[n])
        tail = [int(x) for x in rng.integers(1, 90, size=tail_len)]
        arrivals.append((t, f"p{n}", tmpl_ids[picks[n]] + tail))

    def leg(cache: bool) -> dict:
        engine = make_stub_paged_engine(max_slots=8, max_seq=128, page_size=8, chunk=16,
                                        window=4, chunk_sleep_s=chunk_sleep,
                                        prefix_cache=cache, device=dev)
        hit_rids: set[str] = set()
        pc = engine.prefix_cache
        if pc is not None:
            # serve() renames streams req-N; the trace's rid follows from
            # the prompt (tails are unique by construction).
            rid_by_prompt = {tuple(ids): rid for _at, rid, ids in arrivals}
            orig_submit = engine.submit

            def submit(key, ids, max_new, **kwargs):
                h0 = pc.hits
                res = orig_submit(key, ids, max_new, **kwargs)
                if pc.hits > h0:
                    hit_rids.add(rid_by_prompt[tuple(ids)])
                return res

            engine.submit = submit
        schedule = [
            (at, {
                "type": "INPUT",
                "metadata": {"request_id": rid, "max_new_tokens": max_new},
                "value": " ".join(str(t) for t in ids).encode(),
            })
            for at, rid, ids in arrivals
        ]
        node = _OpenLoopNode(schedule)
        metrics = ServingMetrics(engine="paged")
        c0 = engine.chunks_run
        t0 = time.perf_counter()
        serve(node, engine, metrics, encode=lambda text: [int(t) for t in text.split()],
              decode_one=lambda tok: f" t{tok}", max_new_cap=max_new)
        wall = time.perf_counter() - t0
        ttft_by_rid: dict[str, float] = {}
        for ts, meta in node.sent:
            rid = meta.get("request_id")
            if rid is not None and rid not in ttft_by_rid:
                ttft_by_rid[rid] = ts
        ttfts = {}
        for at, rid, _ids in arrivals:
            if rid not in ttft_by_rid:
                raise RuntimeError(f"stream {rid} silently lost")
            ttfts[rid] = ttft_by_rid[rid] - at
        out = {
            "wall_s": round(wall, 2),
            "prefill_chunks": engine.chunks_run - c0,
            "peak_used_pages": engine.allocator.peak_in_use,
            "total_pages": engine.allocator.num_pages,
            "ttfts": ttfts,
            "hit_rids": sorted(hit_rids),
        }
        if pc is not None:
            out["cache"] = pc.stats()
        return out

    on, off = leg(cache=True), leg(cache=False)
    hit_rids = set(on["hit_rids"])
    hit_on = [v for r, v in on["ttfts"].items() if r in hit_rids]
    hit_off = [v for r, v in off["ttfts"].items() if r in hit_rids]
    all_on = list(on["ttfts"].values())
    all_off = list(off["ttfts"].values())
    for legd in (on, off):
        del legd["ttfts"], legd["hit_rids"]
    cache = on.get("cache", {})
    lookups = cache.get("hits", 0) + cache.get("misses", 0)
    p50_on, p50_off = _pct(hit_on, 0.50, 2), _pct(hit_off, 0.50, 2)
    return {
        "device": device,
        "streams": streams,
        "templates": templates,
        "prefix_len": prefix_len,
        "tail_len": tail_len,
        "hit_rate": round(cache.get("hits", 0) / lookups, 3) if lookups else None,
        "hit_requests": len(hit_rids),
        "cache_on": on,
        "cache_off": off,
        "ttft_ms": {
            "hit_on": {"p50": p50_on, "p99": _pct(hit_on, 0.99, 2)},
            "hit_rids_off": {"p50": p50_off, "p99": _pct(hit_off, 0.99, 2)},
            "all_on": {"p50": _pct(all_on, 0.50, 2), "p99": _pct(all_on, 0.99, 2)},
            "all_off": {"p50": _pct(all_off, 0.50, 2), "p99": _pct(all_off, 0.99, 2)},
        },
        "hit_p50_on_vs_off": (round(p50_on / p50_off, 3)
                              if p50_on is not None and p50_off else None),
    }


#: flag -> (the line's key, the leg); no flag runs the default A/B, whose
#: keys are the line's top level
LEGS = {
    "--multistep": ("multistep", _multistep_sweep),
    "--trace-ab": ("trace_ab", _trace_ab),
    "--quant-ab": ("quant_ab", _quant_ab),
    "--spec-ab": ("spec_ab", _spec_ab),
    "--lora-ab": ("lora_ab", _lora_ab),
    "--profiling-ab": ("profiling_ab", _profiling_ab),
    "--fleet-digest-ab": ("fleet_digest_ab", _fleet_digest_ab),
    "--qos-soak": ("qos_soak", _qos_soak),
    "--prefix-ab": ("prefix_ab", _prefix_ab),
}


def main(argv=None) -> int:
    from dora_tpu_torch._device import resolve_device
    from dora_tpu_torch.tools._common import KernelCounters, device_field

    ap = argparse.ArgumentParser(description="serving A/B legs of the PyTorch/CUDA port")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    legs = ap.add_mutually_exclusive_group()
    for flag in LEGS:
        legs.add_argument(flag, dest="leg", action="store_const", const=flag)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    key, leg = LEGS.get(args.leg, (None, _ab))
    with KernelCounters() as counters:
        out = leg(dev, device_field(dev))
    out.update(counters.report())
    print(json.dumps(out if key is None else {key: out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
