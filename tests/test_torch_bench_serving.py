"""The port's serving A/B legs (dora_tpu_torch/tools/bench_serving.py) on the CPU.

Every leg runs through ``main`` with ``--device cpu`` at the tiny size and
prints one JSON line holding the JAX tool's keys (listed here; the JAX
line's ``backend`` is the port's ``device``), no kernel launch, plain calls
on the model legs only. Against dora_tpu/tools/bench_serving.py on the same
tiny random ``transformers`` Qwen2 and the same seeded prompts: its
``_serve`` on the JAX paged engine and the port's ``_serve`` on the port's
emit the same tokens with the same dispatches and fetches at windows 1 and
8 (and ``_serve_tokens`` the same streams); ``--spec-ab``'s tokens,
dispatches and acceptance equal the JAX leg's in every cell; ``--quant-ab``'s
capacity counts equal the JAX engines' through the leg's own admission
loop. The stub engine's host sleeps keep its streams. Without ``--device
cpu`` every entry point raises here (no card, no silent CPU). Timing fields
are never compared.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import pytest
import torch

from dora_tpu_torch.tools import bench_serving as TB

STATS = {"decode_tok_s", "wall_s", "tokens", "ttft_p50_ms", "ttft_p99_ms"}
#: the JAX tool's keys of each leg, ``backend`` as ``device``; a dict maps a
#: key to the keys of its value
JAX_KEYS = {
    None: {
        "device": None, "model": None, "plen": None, "max_new": None,
        "streams4": {"paged": STATS, "dense": STATS, "paged_vs_dense": None},
        "streams16": {"paged_16slot": STATS, "dense_4slot_queued": STATS,
                      "paged_pool_bytes": None, "dense_4slot_cache_bytes": None,
                      "wall_speedup": None},
    },
    "--multistep": {
        "device": None, "model": None, "plen": None, "max_new": None,
        "k_sweep": {f"streams{s}": {f"k{k}": STATS | {"round_trips", "rt_per_token",
                                                     "tokens_per_dispatch"}
                                    for k in (1, 4, 8, 16)} for s in (4, 16)},
        "k8_vs_k1_rt_reduction": None,
    },
    "--trace-ab": {"off_wall_s", "on_wall_s", "overhead_pct", "span_events_per_run", "trials"},
    "--quant-ab": {
        "device": None, "model": None, "plen": None, "max_new": None, "streams": None,
        **{leg: STATS | {"kv_dtype", "pool_bytes"} for leg in ("fp", "kv_int8", "kv_int8_w4")},
        "greedy_agreement_vs_fp": {"kv_int8", "kv_int8_w4"},
        "capacity": {"fp": {"streams", "pool_bytes", "usable_pages"},
                     "int8": {"streams", "pool_bytes", "usable_pages"},
                     "pool_budget_ratio": None, "int8_capacity_ratio": None},
        "spec": {"acceptance_fp", "drafted_fp", "acceptance_int8", "drafted_int8",
                 "spec_acceptance"},
    },
    "--spec-ab": {
        "max_new": None, "streams": None,
        "legs": {leg: {f"k{k}_K{K}": {"tokens", "dispatches", "tokens_per_dispatch",
                                      "acceptance"} for K in (1, 8) for k in (0, 2, 4)}
                 for leg in ("repetitive", "random")},
        "rep_k4_vs_k0_tpd_at_k8": None, "rand_k4_vs_k0_tpd_at_k8": None,
    },
    "--lora-ab": {
        "tenants": None, "streams_per_tenant": None, "max_new": None, "pool_pages": None,
        "shared": {"tokens", "wall_s", "tok_s"},
        "separate": {"tokens", "wall_s", "tok_s", "pages_each"},
        "lora_aggregate_ratio": None,
        "churn": {"adapters", "resident_budget", "loads", "evictions", "steady_state_compiles"},
    },
    "--profiling-ab": {"streams", "max_new", "trials", "monitor_off_wall_s",
                       "monitor_on_wall_s", "overhead_pct", "gate_pct", "pass"},
    "--fleet-digest-ab": {"streams", "max_new", "trials", "cadence_s", "digests_published",
                          "digest_off_wall_s", "digest_on_wall_s", "overhead_pct", "gate_pct",
                          "pass"},
    "--qos-soak": {
        "streams": None, "arrival_rate_per_s": None, "max_new": None,
        **{leg: {"wall_s", "finishes", "shed", "preempted", "resumed", "ttft_ms"}
           for leg in ("qos_on", "qos_off")},
        "interactive_p99_on_vs_off": None,
    },
    "--prefix-ab": {
        "streams": None, "templates": None, "prefix_len": None, "tail_len": None,
        "hit_rate": None, "hit_requests": None,
        "cache_on": {"wall_s", "prefill_chunks", "peak_used_pages", "total_pages", "cache"},
        "cache_off": {"wall_s", "prefill_chunks", "peak_used_pages", "total_pages"},
        "ttft_ms": {"hit_on", "hit_rids_off", "all_on", "all_off"},
        "hit_p50_on_vs_off": None,
    },
}
MODEL_LEGS = (None, "--multistep", "--trace-ab", "--quant-ab")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the tiny models' products run faster so, and the
    suite's workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_keys(got: dict, want, path: str = "") -> None:
    keys = want if isinstance(want, set) else set(want)
    assert keys <= set(got), (path, sorted(keys - set(got)))
    if isinstance(want, dict):
        for k, sub in want.items():
            if sub is not None:
                _assert_keys(got[k], sub, f"{path}/{k}")


@pytest.fixture
def small(monkeypatch):
    """The knobs that size the legs, at test sizes."""
    monkeypatch.setenv("DORA_BENCH_TRIALS", "2")
    monkeypatch.setenv("DORA_BENCH_QOS_STREAMS", "100")
    monkeypatch.setenv("DORA_BENCH_PREFIX_STREAMS", "30")
    monkeypatch.delenv("DORA_HF_CHECKPOINT", raising=False)


def _run(capsys, flag) -> dict:
    """``main`` with ``--device cpu``: its one line, under the leg's key."""
    assert TB.main(["--device", "cpu"] + ([flag] if flag else [])) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(lines) == 1, lines
    line = json.loads(lines[0])
    if flag is None:
        return line
    (key,) = line
    assert key == TB.LEGS[flag][0]
    return line[key]


def _check_line(leg: dict, flag) -> None:
    _assert_keys(leg, JAX_KEYS[flag])
    assert leg["device"] == "cpu"
    assert leg["launches"] == {}  # a CPU tensor runs the plain version, no kernel
    if flag in MODEL_LEGS:
        assert leg["model"] == "tiny-random" and leg["plain_calls"] > 0
    else:
        assert leg["plain_calls"] == 0  # the stub engine runs no model


@pytest.mark.parametrize("flag", [None, "--multistep", "--trace-ab", "--lora-ab",
                                  "--profiling-ab", "--fleet-digest-ab", "--qos-soak",
                                  "--prefix-ab"])
def test_leg_prints_the_jax_keys(flag, small, capsys):
    leg = _run(capsys, flag)
    _check_line(leg, flag)
    if flag == "--multistep":
        s4 = leg["k_sweep"]["streams4"]
        assert s4["k1"]["tokens"] == 4 * 120 and s4["k8"]["rt_per_token"] < s4["k1"]["rt_per_token"]
    if flag == "--lora-ab":
        assert leg["churn"]["steady_state_compiles"] == 0
        assert leg["shared"]["tokens"] == leg["separate"]["tokens"] == 4 * 2 * 64
    if flag == "--qos-soak":
        for side in ("qos_on", "qos_off"):  # every stream ends, none is lost
            assert sum(leg[side]["finishes"].values()) == 100
    if flag == "--prefix-ab":
        assert leg["hit_requests"] > 0
        assert leg["cache_on"]["prefill_chunks"] < leg["cache_off"]["prefill_chunks"]


# ---------------------------------------------------------------------------
# parity with dora_tpu/tools/bench_serving.py
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(jax cfg, jax int8 params, port cfg, port int8 params) of the tiny
    checkpoint both tools build, each loaded and quantized by its own
    package (byte-identical trees, tests/test_torch_paged_engine.py)."""
    from dora_tpu.models.hf import qwen2 as jq
    from dora_tpu_torch.models.hf import qwen2 as tq

    path = TB._tiny_checkpoint(str(tmp_path_factory.mktemp("bench-serving")))
    cfg, params = jq.load(path, max_seq=64)
    os.environ["DORA_INT8_DECODE"] = "1"
    try:
        jparams = jq.quantize_decode(params, cfg)
    finally:
        os.environ.pop("DORA_INT8_DECODE", None)
    tcfg, tparams = tq.load(path, max_seq=64, device="cpu")
    return cfg, jparams, tcfg, tq.quantize_decode(tparams, tcfg)


@pytest.mark.parametrize("window", [1, 8])
def test_serve_counts_and_streams_match_jax(both, window):
    from dora_tpu.models.hf import qwen2 as jq
    from dora_tpu.tools import bench_serving as JB
    from dora_tpu_torch.models.hf import qwen2 as tq

    cfg, jparams, tcfg, tparams = both
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab, size=n).tolist() for n in (4, 4, 11, 4, 7)]
    kw = dict(max_slots=4, page_size=8, chunk=8, window=window)
    got = {}
    for name, serve, serve_tokens, engine in (
        ("jax", JB._serve, JB._serve_tokens, jq.make_paged_engine(jparams, cfg, **kw)),
        ("port", TB._serve, TB._serve_tokens,
         tq.make_paged_engine(tparams, tcfg, device="cpu", **kw)),
    ):
        tokens, _wall, ttfts = serve(engine, prompts, 24)
        counts = (tokens, engine.dispatches, engine.fetches, len(ttfts))
        seqs, _wall, _ = serve_tokens(engine, prompts, 24)
        got[name] = (counts, (engine.dispatches, engine.fetches), seqs)
    assert got["port"] == got["jax"]
    assert got["port"][0][0] == 5 * 24


def test_spec_ab_matches_the_jax_leg(small, capsys):
    from dora_tpu.tools import bench_serving as JB

    leg = _run(capsys, "--spec-ab")
    _check_line(leg, "--spec-ab")
    want = JB._spec_ab()
    for rule in ("repetitive", "random"):
        for cell, jcell in want["legs"][rule].items():
            pcell = leg["legs"][rule][cell]
            assert {k: pcell[k] for k in ("tokens", "dispatches", "acceptance")} == {
                k: jcell[k] for k in ("tokens", "dispatches", "acceptance")}, (rule, cell)
    # the headline cells: K 8, k 4
    assert leg["legs"]["repetitive"]["k4_K8"]["dispatches"] < leg["legs"]["random"]["k4_K8"][
        "dispatches"]


def test_quant_ab_capacity_matches_jax(both, small, capsys):
    from dora_tpu.models.hf import qwen2 as jq

    leg = _run(capsys, "--quant-ab")
    _check_line(leg, "--quant-ab")
    assert leg["greedy_agreement_vs_fp"]["kv_int8"] is not None
    cfg, jparams, _, _ = both
    plen, max_new = leg["plen"], leg["max_new"]
    for name, kv8 in (("fp", False), ("int8", True)):
        # the JAX leg's capacity loop, on the JAX engine
        engine = jq.make_paged_engine(jparams, cfg, max_slots=512, page_size=8, chunk=8,
                                      kv_int8=kv8)
        n = 0
        while n < 512 and engine.can_admit(plen, max_new):
            engine.submit(f"cap{n}", [1] * plen, max_new)
            n += 1
        assert leg["capacity"][name]["streams"] == n, name
        assert leg["capacity"][name]["usable_pages"] == engine.allocator.num_pages - 1
    assert leg["capacity"]["int8"]["streams"] > leg["capacity"]["fp"]["streams"]


# ---------------------------------------------------------------------------
# the stub engine's host sleeps, and no CPU fallback
# ---------------------------------------------------------------------------


def test_stub_sleeps_keep_the_streams():
    from dora_tpu_torch.models.batch_engine import make_stub_paged_engine

    prompts = [[5], [6, 7, 8]]
    kw = dict(max_slots=2, max_seq=64, page_size=8, chunk=16, window=4, device="cpu")
    plain = make_stub_paged_engine(**kw)
    slept = make_stub_paged_engine(tick_sleep_s=0.01, chunk_sleep_s=0.02, **kw)
    want, _ = TB._serve_tokens(plain, prompts, 9)[:2]
    t0 = time.perf_counter()
    got, _ = TB._serve_tokens(slept, prompts, 9)[:2]
    wall = time.perf_counter() - t0
    assert got == want
    # two chunks and at least two windows of K = 4 ticks
    assert wall >= 2 * 0.02 + 2 * 4 * 0.01
    assert slept.chunks_run == plain.chunks_run
    assert slept.graph_captures == plain.graph_captures == 1  # through the sleeping runner


@pytest.mark.parametrize("flag", [None, "--multistep", "--spec-ab", "--qos-soak"])
def test_no_cpu_fallback(flag):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TB.main([flag] if flag else [])
