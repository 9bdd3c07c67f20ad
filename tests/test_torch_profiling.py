"""The port's device plane (dora_tpu_torch/profiling.py and the engines'
counters) against dora_tpu.profiling, on the CPU.

The analytic FLOPs model gives the JAX package's numbers on Qwen2-0.5B,
1.5B and 7B shapes and over a grid of windows; the peak comes from
``DORA_DEVICE_PEAK_FLOPS``, else the card's name (the H100 SXM data sheet
figure), else 0.0; the monitor reads nothing off a CPU device; a capture
round trip always leaves an artifact; and on the tiny paged and dense
engines with the monitor on, the FLOPs ledger and the time split fill as
tests/test_profiling.py checks the JAX stub engine's, and stay at 0 with
``DORA_DEVICE_MONITOR=0``.
"""

from __future__ import annotations

import json
import os

import pytest
import torch

from dora_tpu import profiling as jp
from dora_tpu_torch import profiling as tp
from tests.test_torch_paged_engine import both, tiny_qwen2  # noqa: F401 (fixtures)

#: (dim, layers, heads, kv_heads, ffn, vocab) of each model's config.json
_SHAPES = {
    "qwen2-0.5b": (896, 24, 14, 2, 4864, 151936),
    "qwen2-1.5b": (1536, 28, 12, 2, 8960, 151936),
    "qwen2-7b": (3584, 28, 28, 4, 18944, 152064),
}


@pytest.mark.parametrize("name", sorted(_SHAPES))
def test_flops_per_token_matches_jax(name):
    from dora_tpu.models.hf.qwen2 import Qwen2Config as JConfig
    from dora_tpu_torch.models.hf.qwen2 import Qwen2Config as TConfig

    dim, layers, heads, kv, ffn, vocab = _SHAPES[name]
    kw = dict(dim=dim, layers=layers, heads=heads, kv_heads=kv, ffn=ffn, vocab=vocab)
    assert tp.flops_per_token(**kw) == jp.flops_per_token(**kw) > 0
    common = dict(vocab=vocab, dim=dim, layers=layers, heads=heads, kv_heads=kv, ffn=ffn,
                  rope_theta=1e6, norm_eps=1e-6, tie_embeddings=False)
    assert (tp.flops_per_token_config(TConfig(**common))
            == jp.flops_per_token_config(JConfig(**common)) == tp.flops_per_token(**kw))


@pytest.mark.parametrize("k", (1, 4, 8))
@pytest.mark.parametrize("spec_k", (0, 2, 4))
def test_window_flops_matches_jax(k, spec_k):
    for active in (0, 1, 16):
        kw = dict(flops_per_token=3_000_000_000, active=active, k=k, spec_k=spec_k)
        assert tp.window_flops(**kw) == jp.window_flops(**kw) == active * k * (spec_k + 1) * 3e9


@pytest.mark.parametrize("value", ("1", "0", "", "false", "yes"))
def test_monitor_enabled_matches_jax(monkeypatch, value):
    monkeypatch.setenv("DORA_DEVICE_MONITOR", value)
    assert tp.monitor_enabled() == jp.monitor_enabled()
    monkeypatch.delenv("DORA_DEVICE_MONITOR")
    assert tp.monitor_enabled() and jp.monitor_enabled()


def _card(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: name)


def test_detect_peak_flops_env_wins(monkeypatch):
    monkeypatch.setenv("DORA_DEVICE_PEAK_FLOPS", "1.5e14")
    assert tp.detect_peak_flops() == jp.detect_peak_flops() == 1.5e14
    _card(monkeypatch, "NVIDIA H100 80GB HBM3")
    assert tp.detect_peak_flops("cuda") == 1.5e14
    # a value that is no number falls through to the name table
    monkeypatch.setenv("DORA_DEVICE_PEAK_FLOPS", "fast")
    assert tp.detect_peak_flops("cuda") == 989e12


@pytest.mark.parametrize("name,peak", [
    ("NVIDIA H100 80GB HBM3", 989e12),   # the SXM part: the data sheet's dense bf16
    ("NVIDIA H100 SXM5 80GB", 989e12),
    ("NVIDIA A100-SXM4-40GB", 0.0),      # unknown cards: no made-up number
    ("NVIDIA GeForce RTX 4090", 0.0),
])
def test_detect_peak_flops_by_card_name(monkeypatch, name, peak):
    monkeypatch.delenv("DORA_DEVICE_PEAK_FLOPS", raising=False)
    _card(monkeypatch, name)
    assert tp.detect_peak_flops() == peak
    assert tp.DeviceMonitor("cuda").peak_flops() == peak


def test_detect_peak_flops_without_a_card_is_zero(monkeypatch):
    monkeypatch.delenv("DORA_DEVICE_PEAK_FLOPS", raising=False)
    assert tp.detect_peak_flops("cpu") == 0.0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert tp.detect_peak_flops() == 0.0


def test_device_monitor_on_the_cpu_reads_nones():
    want = {"used": None, "limit": None, "peak": None}
    assert tp.DeviceMonitor("cpu").memory() == want
    assert tp.DeviceMonitor(torch.device("cpu")).memory() == want
    # the JAX monitor on a device without allocator stats says the same
    assert jp.DeviceMonitor(object()).memory() == want


def test_device_monitor_maps_the_allocator(monkeypatch):
    stats = {"allocated_bytes.all.current": 100, "allocated_bytes.all.peak": 500}
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda device=None: stats)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (1, 1000))
    assert tp.DeviceMonitor("cuda").memory() == {"used": 100, "limit": 1000, "peak": 500}

    def fails(device=None):
        raise RuntimeError("CUDA unavailable")

    monkeypatch.setattr(torch.cuda, "memory_stats", fails)
    assert tp.DeviceMonitor("cuda").memory() == {"used": None, "limit": None, "peak": None}


def test_capture_round_trip_writes_a_trace(tmp_path):
    out = str(tmp_path / "cap")
    assert tp.start_capture(out) is None
    torch.ones(64, 64) @ torch.ones(64, 64)
    artifact = tp.stop_capture(out)
    assert artifact == out
    with open(os.path.join(out, "trace.json")) as f:
        assert "traceEvents" in json.load(f)
    assert not os.path.exists(os.path.join(out, "profile_synthetic.json"))


@pytest.mark.parametrize("case", ("start_error", "never_started"))
def test_capture_without_a_profiler_leaves_a_marker(tmp_path, case):
    out = str(tmp_path / case)
    if case == "start_error":
        artifact = tp.stop_capture(out, "RuntimeError: profiler busy")
    else:
        artifact = tp.stop_capture(out)
    assert artifact == os.path.join(out, "profile_synthetic.json")
    with open(artifact) as f:
        marker = json.load(f)
    assert marker["synthetic"] is True
    assert ("profiler busy" if case == "start_error" else "no capture") in marker["reason"]
    assert tp.profile_dir()


def _serve(engine, prompts, max_new=6):
    from dora_tpu_torch.nodehub.llm_server import serve_prompts

    out, _ = serve_prompts(engine, prompts, max_new)
    return sum(len(t) for t in out.values())


@pytest.mark.parametrize("engine_kind", ("paged", "paged_spec", "dense"))
def test_engine_device_plane_fills_its_ledger(both, monkeypatch, engine_kind):  # noqa: F811
    from dora_tpu_torch.models.hf import qwen2 as tq

    monkeypatch.setenv("DORA_DEVICE_MONITOR", "1")
    monkeypatch.delenv("DORA_DEVICE_PEAK_FLOPS", raising=False)
    _, _, tcfg, tparams = both
    if engine_kind == "dense":
        engine = tq.make_batch_engine(tparams, tcfg, max_slots=2, device="cpu")
    else:
        engine = tq.make_paged_engine(tparams, tcfg, max_slots=2, page_size=8, chunk=8,
                                      window=4, spec_k=4 if engine_kind == "paged_spec" else 0,
                                      device="cpu")
    assert engine.device_monitor
    assert engine.flops_per_token == tp.flops_per_token_config(tcfg) > 0
    assert engine.device_peak_flops == 0.0  # a CPU device: MFU renders as a dash
    emitted = _serve(engine, [[3, 4, 5], [6, 7], [8, 9, 10, 11, 12, 13, 14, 15, 16, 17]])
    assert emitted == 18
    assert engine.host_dispatch_ns > 0
    assert engine.device_compute_ns >= 0 and engine.device_fetch_ns > 0
    assert 0 < engine.useful_flops <= engine.dispatched_flops
    assert engine.useful_flops % engine.flops_per_token == 0


@pytest.mark.parametrize("engine_kind", ("paged", "dense"))
def test_engine_monitor_off_strips_the_hooks(both, monkeypatch, engine_kind):  # noqa: F811
    from dora_tpu_torch.models.hf import qwen2 as tq

    monkeypatch.setenv("DORA_DEVICE_MONITOR", "0")
    _, _, tcfg, tparams = both
    if engine_kind == "dense":
        engine = tq.make_batch_engine(tparams, tcfg, max_slots=1, device="cpu")
    else:
        engine = tq.make_paged_engine(tparams, tcfg, max_slots=1, page_size=8, chunk=8,
                                      window=4, device="cpu")
    assert not engine.device_monitor
    assert _serve(engine, [[3, 4]]) == 6
    assert engine.host_dispatch_ns == engine.device_compute_ns == engine.device_fetch_ns == 0
    assert engine.dispatched_flops == engine.useful_flops == 0
