"""The port's metrics history, alert and view planes (dora_tpu_torch
.metrics_history, .alerts, .analysis.alertcheck, .cli.*_view) against the JAX
package's, on the CPU.

The same seeded snapshot sequences (the daemon's ``metrics_snapshot`` shape:
links, drops, latency histograms, a serving node's counters and gauges, log
counts, trace drops, fleet gauges; counter resets where a node respawned) go
through both packages under injected clocks, and every output is held equal
(``==`` on the JSON-able values and the rendered text):

* ``MetricsHistoryRing`` (delta encoding, counter resets, wrap losses, SLO
  violations and burn gauges), ``merge_history_snapshots`` of two machines
  whose clocks are skewed, and the derivations (rates, percentiles, util,
  the sparkline series);
* ``AlertEngine`` over the ring, tick by tick: the transitions, the status,
  the JSONL sink's lines, for the default pack and for a descriptor's
  ``alerts:`` overrides; the merged-history evaluation; ``merge_alert_status``;
* ``alertcheck``'s findings on a set of bad rules and sink settings;
* the four CLI views (``metrics``, ``top``, ``fleet``, ``alerts``).
"""

from __future__ import annotations

import copy
import dataclasses
import time

import numpy as np
import pytest

from dora_tpu import alerts as jalerts
from dora_tpu import metrics as jmetrics
from dora_tpu import metrics_history as jhist
from dora_tpu.analysis import alertcheck as jcheck
from dora_tpu.cli import alerts_view as jalerts_view
from dora_tpu.cli import fleet_view as jfleet_view
from dora_tpu.cli import metrics_view as jmetrics_view
from dora_tpu.cli import top_view as jtop_view
from dora_tpu.core import descriptor as jdesc
from dora_tpu_torch import alerts as palerts
from dora_tpu_torch import metrics as pmetrics
from dora_tpu_torch import metrics_history as phist
from dora_tpu_torch.analysis import alertcheck as pcheck
from dora_tpu_torch.cli import alerts_view as palerts_view
from dora_tpu_torch.cli import fleet_view as pfleet_view
from dora_tpu_torch.cli import metrics_view as pmetrics_view
from dora_tpu_torch.cli import top_view as ptop_view
from dora_tpu_torch.core import descriptor as pdesc

T0_NS = 1_760_000_000_000_000_000
INTERVAL_S = 1.0
#: machine B's HLC offset (its wall clock runs 0.37 s behind the cluster's)
SKEW_NS = 370_000_000


def _load(i: int, n: int) -> float:
    """A busy stretch in the middle third of the run, idle around it."""
    return 1.0 if n // 3 <= i < 2 * n // 3 else 0.05


def snapshots(seed: int, n: int, node: str = "llm", reset_at: tuple = ()) -> list[dict]:
    """``n`` cumulative metrics snapshots of one machine, made from a seed:
    the daemon's routing block from ``DataflowMetrics``, the serving node's
    from ``ServingMetrics``; the serving counters restart at ``reset_at``
    (a respawned node reports from zero)."""
    rng = np.random.default_rng(seed)
    dm = jmetrics.DataflowMetrics()
    sm = jmetrics.ServingMetrics()
    logs = [0, 0]
    trace_drops = 0
    out = []
    for i in range(n):
        load = _load(i, n)
        if i in reset_at:
            sm = jmetrics.ServingMetrics()
            dm.count_respawn(node)
            dm.count_replayed(node, int(rng.integers(1, 5)))
        for _ in range(int(rng.integers(1, 40) * load) + 1):
            dm.count_link("api", "text", int(rng.integers(16, 4096)))
            dm.count_link(node, "response", int(rng.integers(8, 64)))
            dm.observe_latency(node, "text", float(rng.gamma(2.0, 300.0 / load)))
            dm.observe_latency("api", "response", float(rng.gamma(2.0, 80.0)))
        if rng.random() < 0.3 * load:
            dm.count_drop("api", "response")
        dm.fastroute_hits += int(rng.integers(0, 50))
        dm.fastroute_fallbacks += int(rng.integers(0, 3))
        tokens = int(rng.integers(200, 900) * load)
        sm.decode_tokens += tokens
        sm.requests += int(rng.integers(0, 6) * load)
        sm.prefill_chunks += int(rng.integers(0, 10) * load)
        sm.host_dispatches += tokens // 8
        sm.shed += int(rng.random() < 0.4 * load)
        sm.lora_loads += int(rng.integers(0, 4) * load)
        sm.device_compute_ns += int(rng.integers(1, 900_000_000) * load)
        for _ in range(int(rng.integers(0, 6) * load)):
            sm.ttft.observe(float(rng.gamma(2.0, 40_000.0 / load)))
        sm.slots_active = int(16 * load)
        sm.slots_total = 16
        sm.backlog_depth = int(rng.integers(0, 60) * load)
        sm.total_pages, sm.used_pages = 512, int(500 * load)
        sm.free_pages = sm.total_pages - sm.used_pages
        sm.hbm_limit_bytes = 80 << 30
        sm.hbm_used_bytes = int((0.5 + 0.47 * load) * sm.hbm_limit_bytes)
        sm.device_busy_fraction = round(float(rng.random() * load), 4)
        sm.mfu = round(float(rng.random() * 0.3 * load), 4)
        sm.qos_depth = {"interactive": int(rng.integers(0, 4)), "batch": int(rng.integers(0, 9))}
        logs[0] += int(rng.integers(0, 5) * load)
        logs[1] += int(rng.integers(0, 3))
        trace_drops += int(rng.integers(0, 200) * (load > 0.5))
        snap = dm.snapshot({f"{node}/text": int(400 * load + rng.integers(0, 30)),
                            "api/response": int(rng.integers(0, 12))})
        snap["serving"] = {node: sm.snapshot()}
        snap["serving"][node].pop("checkpoint_age_s", None)  # reads the wall clock
        snap["logs"] = {node: {"errors": logs[0], "warns": logs[1]}}
        if trace_drops:
            snap["trace"] = {"drops": {node: trace_drops}}
        snap["fleet"] = {node: {"digest_age_s": round(float(rng.gamma(2.0, 1.5 + 6 * load)), 3),
                                "free_streams": int(16 - sm.slots_active),
                                "used_pages": sm.used_pages, "total_pages": sm.total_pages,
                                "occupancy": round(sm.used_pages / sm.total_pages, 4),
                                "prefix_pages": int(rng.integers(0, 40))}}
        out.append(snap)
    return out


def _stamps(i: int, skew_ns: int = 0, jitter=None) -> tuple[int, int]:
    """(wall_ns, hlc_ns) of sample ``i`` on a machine whose wall clock is
    ``skew_ns`` behind the cluster's."""
    wall = T0_NS + int(i * INTERVAL_S * 1e9) - skew_ns
    if jitter is not None:
        wall += int(jitter.integers(0, 40_000_000))
    return wall, wall + skew_ns


SLO = {"llm": {"ttft_p99_ms": 120.0, "tokens_per_s_min": 150.0, "queue_depth_max": 200}}


def _fill(hist_mod, snaps, capacity=None, skew_ns=0, slo=SLO, seed=0):
    ring = hist_mod.MetricsHistoryRing(capacity=capacity, interval_s=INTERVAL_S,
                                       slo_targets=slo)
    jitter = np.random.default_rng(seed)
    events = []
    for i, snap in enumerate(snaps):
        wall, hlc = _stamps(i, skew_ns, jitter)
        events.append(ring.sample(copy.deepcopy(snap), wall, hlc))
    return ring, events


@pytest.mark.parametrize("seed,capacity,resets", [(0, None, ()), (1, 24, (20, 33)),
                                                   (2, 7, (11,))])
def test_ring_equals_jax(seed, capacity, resets):
    """Delta encoding, counter-reset counts, wrap losses, SLO violations
    and burn gauges, sample by sample."""
    snaps = snapshots(seed, 48, reset_at=resets)
    jring, jevents = _fill(jhist, snaps, capacity)
    pring, pevents = _fill(phist, snaps, capacity)
    assert pevents == jevents
    assert any(jevents), "the sequence must violate an SLO somewhere"
    assert pring.snapshot() == jring.snapshot()
    assert pring.slo_status() == jring.slo_status()
    assert (pring.resets, pring.dropped, len(pring)) == (jring.resets, jring.dropped, len(jring))
    if resets:
        assert pring.resets["srv:llm:decode_tokens"] == len(resets)
    if capacity is not None:
        assert pring.dropped == 48 - capacity


def test_flatten_and_knobs_equal_jax(monkeypatch):
    for snap in snapshots(3, 12, reset_at=(5,)):
        assert phist.flatten_snapshot(snap) == jhist.flatten_snapshot(snap)
    for raw in ("", "0.2", "0", "-1", "junk"):
        monkeypatch.setenv("DORA_METRICS_HISTORY_S", raw)
        assert phist.history_interval_s() == jhist.history_interval_s()
    for raw in ("", "5", "1", "junk"):
        monkeypatch.setenv("DORA_METRICS_HISTORY_LEN", raw)
        assert phist.history_capacity() == jhist.history_capacity()
    for args in ((0, 60.0, 1.0), (59, 60.0, 1.0), (60, 60.0, 1.0), (3, 1.0, 0.0)):
        assert phist.burn_window_complete(*args) == jhist.burn_window_complete(*args)


def _machine_snapshots(hist_mod, seed: int) -> list[dict]:
    """Two machines' ring exports, as each daemon's ``history_snapshot``
    gives them: A on the cluster clock, B skewed by SKEW_NS."""
    parts = []
    for k, (machine, skew) in enumerate((("A", 0), ("B", SKEW_NS))):
        snaps = snapshots(seed + k, 40, node="llm" if machine == "B" else "tts")
        ring, _ = _fill(hist_mod, snaps, skew_ns=skew, seed=seed + k,
                        slo=SLO if machine == "B" else {})
        out = ring.snapshot()
        wall, hlc = _stamps(41, skew)
        out.update(machine_id=machine, wall_ns=wall, hlc_ns=hlc)
        parts.append(out)
    return parts


@pytest.mark.parametrize("seed", [4, 5])
def test_merge_across_skewed_machines_equals_jax(seed):
    jparts, pparts = _machine_snapshots(jhist, seed), _machine_snapshots(phist, seed)
    assert pparts == jparts
    merged = phist.merge_history_snapshots(copy.deepcopy(pparts))
    want = jhist.merge_history_snapshots(copy.deepcopy(jparts))
    assert merged == want
    assert merged["machines"] == ["A", "B"]
    # B's samples land on the cluster axis: interleaved with A's, not 0.37 s early
    b_first = next(s["t_ns"] for s in merged["samples"] if s["machine"] == "B")
    assert abs(b_first - T0_NS) < 50_000_000
    assert merged["samples"][0]["t_ns"] < T0_NS + 50_000_000
    for fn, args in ((phist.derive_rates, (merged["samples"],)),
                     (phist.derive_rates, (merged["samples"], 10.0)),
                     (phist.derive_percentiles, (merged["samples"],)),
                     (phist.derive_util, (merged["samples"],))):
        assert fn(*args) == getattr(jhist, fn.__name__)(*args)
    for key in ("srv:llm:decode_tokens", "link:api/text:msgs", "fastroute:hits"):
        assert phist.counter_series(merged, key) == jhist.counter_series(want, key)
    for key in ("srv:llm:used_pages", "queue:llm/text", "fleet:llm:digest_age_s"):
        assert phist.gauge_series(merged, key, points=12) == jhist.gauge_series(want, key, 12)
    assert phist.merge_history_snapshots([{}, pparts[0]]) == jhist.merge_history_snapshots(
        [{}, jparts[0]])
    assert phist.merge_history_snapshots([]) == jhist.merge_history_snapshots([])


# ---------------------------------------------------------------------------
# alerts
# ---------------------------------------------------------------------------

#: a descriptor's alerts block: one pack rule disabled, two overridden, one
#: rule of each other kind
POLICY = {
    "disable": ["fleet-digest-stale"],
    "rules": [
        {"name": "queue-depth", "kind": "gauge", "selector": "queue:*", "op": ">",
         "threshold": 300, "for_s": 3, "resolve_threshold": 100, "severity": "critical"},
        {"name": "shed-spike", "kind": "rate", "selector": "srv:*:shed", "op": ">",
         "threshold": 0.2, "for_s": 2, "clear_s": 4},
        {"name": "busy", "kind": "rate", "selector": "srv:*:decode_tokens", "op": ">",
         "threshold": 50, "window_s": 3, "labels": {"team": "serving"}},
        {"name": "thrash", "kind": "ratio", "selector": "srv:*:lora_loads",
         "denominator": "srv:*:requests", "op": ">=", "threshold": 0.4, "min_rate": 0.1,
         "for_s": 1},
        {"name": "slow-links", "kind": "percentile", "selector": "lat:*", "percentile": 90,
         "op": ">", "threshold": 1500, "window_s": 5},
        {"name": "hbm", "kind": "gauge_ratio", "selector": "srv:*:hbm_used_bytes",
         "denominator": "srv:*:hbm_limit_bytes", "op": ">", "threshold": 0.9,
         "resolve_threshold": 0.8},
        {"name": "burn", "kind": "burn", "selector": "*", "op": ">", "threshold": 0.05,
         "window_s": 60},
        {"name": "tail", "kind": "percentile", "selector": "srv:*:ttft_us", "op": "<",
         "threshold": 1e9, "window_s": 4, "severity": "info"},
    ],
}


def _run_engine(alerts_mod, hist_mod, policy, tmp_path, tag: str, snaps):
    parsed = alerts_mod.AlertsPolicy.parse(policy) if policy is not None else None
    sink = alerts_mod.JsonlSink(str(tmp_path / f"{tag}.jsonl"))
    engine = alerts_mod.AlertEngine(alerts_mod.resolved_rules(parsed), interval_s=INTERVAL_S,
                                    sinks=[sink])
    ring = hist_mod.MetricsHistoryRing(interval_s=INTERVAL_S, slo_targets=SLO)
    ticks = []
    for i, snap in enumerate(snaps):
        wall, hlc = _stamps(i)
        ring.sample(copy.deepcopy(snap), wall, hlc)
        ticks.append((engine.evaluate_ring(ring, wall), engine.status()))
    return engine, ticks, (tmp_path / f"{tag}.jsonl").read_text()


@pytest.mark.parametrize("policy", [None, POLICY], ids=["default-pack", "overrides"])
def test_alert_engine_equals_jax(tmp_path, monkeypatch, policy):
    """Pending -> firing -> resolved with hysteresis, tick by tick: the same
    transitions, status and sink lines."""
    monkeypatch.setenv("DORA_FLEET_DIGEST_S", "2")
    snaps = snapshots(7, 72, reset_at=(50,))
    jengine, jticks, jlines = _run_engine(jalerts, jhist, policy, tmp_path, "jax", snaps)
    pengine, pticks, plines = _run_engine(palerts, phist, policy, tmp_path, "port", snaps)
    assert [r.name for r in pengine.rules] == [r.name for r in jengine.rules]
    assert [dataclasses.asdict(r) for r in pengine.rules] == \
        [dataclasses.asdict(r) for r in jengine.rules]
    assert pticks == jticks
    assert plines == jlines
    phases = {(e["rule"], e["phase"]) for events, _ in jticks for e in events}
    fired = {rule for rule, phase in phases if phase == "firing"}
    resolved = {rule for rule, phase in phases if phase == "resolved"}
    assert len(fired) >= 3 and resolved, phases
    if policy is not None:
        assert {"queue-depth", "busy", "hbm"} <= fired, phases
    status = pengine.status()
    assert status["transitions"]["firing"] == sum(status["firing_total"].values())


def test_merged_evaluation_and_status_merge_equal_jax(tmp_path):
    jparts, pparts = _machine_snapshots(jhist, 8), _machine_snapshots(phist, 8)
    jmerged = jhist.merge_history_snapshots(jparts)
    pmerged = phist.merge_history_snapshots(pparts)
    policy = POLICY["rules"]
    jengine = jalerts.AlertEngine([jalerts.AlertRule.parse(r) for r in policy], INTERVAL_S)
    pengine = palerts.AlertEngine([palerts.AlertRule.parse(r) for r in policy], INTERVAL_S)
    now = T0_NS + 45 * 10**9
    assert pengine.evaluate_merged(pmerged, now) == jengine.evaluate_merged(jmerged, now)
    statuses = []
    for k, snaps in enumerate((snapshots(9, 40), snapshots(10, 40, node="tts"))):
        _, ticks, _ = _run_engine(jalerts, jhist, POLICY, tmp_path, f"m{k}", snaps)
        statuses.append({**ticks[-1][1], "machine_id": "AB"[k]})
    statuses.insert(1, {})
    assert palerts.merge_alert_status(statuses) == jalerts.merge_alert_status(statuses)
    merged = palerts.merge_alert_status(statuses)
    assert palerts.active_alerts(merged) == jalerts.active_alerts(merged)
    # the coordinator's metrics merge carries the alerts block the same way
    snaps = [{**s, "alerts": st} for s, st in zip(snapshots(11, 2), statuses[::2])]
    assert pmetrics.merge_snapshots(snaps) == jmetrics.merge_snapshots(snaps)


def test_engine_for_and_sinks_equal_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("DORA_ALERT_SINK", "log,jsonl,webhook,bogus")
    monkeypatch.setenv("DORA_ALERT_SINK_FILE", str(tmp_path / "a.jsonl"))
    monkeypatch.setenv("DORA_ALERT_SINK_WEBHOOK", "http://127.0.0.1:9/hook")
    monkeypatch.setenv("DORA_ALERT_WEBHOOK_RETRIES", "3")
    got = [(type(s).__name__, vars(s)) for s in palerts.sinks_from_env()]
    want = [(type(s).__name__, vars(s)) for s in jalerts.sinks_from_env()]
    assert got == want and [name for name, _ in got] == ["LogSink", "JsonlSink", "WebhookSink"]
    policy = pdesc.Descriptor.parse({"nodes": [{"id": "a", "path": "python"}],
                                     "alerts": POLICY}).alerts
    engine = palerts.engine_for(policy, interval_s=0.5, sinks=[])
    assert engine is not None and engine.interval_s == 0.5
    assert [r.name for r in engine.rules] == [r.name for r in jalerts.engine_for(
        jalerts.AlertsPolicy.parse(POLICY), interval_s=0.5, sinks=[]).rules]
    monkeypatch.setenv("DORA_ALERTS", "0")
    assert palerts.engine_for(policy) is None and jalerts.engine_for(None) is None
    for key in ("fastroute:hits", "link:a/b:msgs", "srv:*:ttft_us", "srv:*:requests",
                "srv:*:used_pages", "srv:*:qos_depth:batch", "fleet:*:occupancy", "queue:*",
                "lat:x/y", "srv:*", "fleet:x", "bogus:*", "srv:*:nope"):
        assert palerts.selector_class(key) == jalerts.selector_class(key), key
    for sel, key in (("srv:*:shed", "srv:llm:shed"), ("queue:*", "queue:a/b"),
                     ("x", "x"), ("x", "y"), ("a*b", "ab"), ("a*b", "b")):
        assert palerts.match_selector(sel, key) == jalerts.match_selector(sel, key)


BAD_RULES = {"rules": [
    {"name": "typo", "kind": "rate", "selector": "srv:*:bogus", "op": ">", "threshold": 1},
    {"name": "kind", "kind": "rate", "selector": "queue:*", "op": ">", "threshold": 1},
    {"name": "ratio-den", "kind": "ratio", "selector": "srv:*:shed",
     "denominator": "srv:*:used_pages", "op": ">", "threshold": 1},
    {"name": "short", "kind": "gauge", "selector": "queue:*", "op": ">", "threshold": 1,
     "for_s": 0.5},
    {"name": "pct", "kind": "percentile", "selector": "srv:*:requests", "op": ">",
     "threshold": 1},
    {"name": "burn-ok", "kind": "burn", "selector": "anything", "op": ">", "threshold": 1},
    {"name": "fine", "kind": "gauge", "selector": "srv:*:backlog_depth", "op": ">",
     "threshold": 1, "for_s": 2},
]}


@pytest.mark.parametrize("env", [{}, {"DORA_ALERT_SINK": "webhook"},
                                 {"DORA_ALERT_SINK": "jsonl,webhook",
                                  "DORA_ALERT_SINK_WEBHOOK": "http://127.0.0.1:9/x"}])
def test_alertcheck_findings_equal_jax(monkeypatch, env):
    for key in ("DORA_ALERT_SINK", "DORA_ALERT_SINK_WEBHOOK"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    raw = {"nodes": [{"id": "a", "path": "python"}], "alerts": BAD_RULES}
    got = [f.to_dict() for f in pcheck.check_alerts(pdesc.Descriptor.parse(raw), 1.0)]
    want = [f.to_dict() for f in jcheck.check_alerts(jdesc.Descriptor.parse(raw), 1.0)]
    assert got == want
    codes = {f["code"] for f in got}
    assert {"alert-unknown-metric", "alert-kind-mismatch", "alert-for-below-cadence",
            "alert-percentile-non-histogram"} <= codes
    assert ("alert-webhook-no-endpoint" in codes) == (env == {"DORA_ALERT_SINK": "webhook"})
    # the default pack alone lints clean, as the JAX package's does
    clean = pdesc.Descriptor.parse({"nodes": [{"id": "a", "path": "python"}]})
    assert [f.to_dict() for f in pcheck.check_alerts(clean, 1.0)] == [
        f.to_dict() for f in jcheck.check_alerts(jdesc.Descriptor.parse(
            {"nodes": [{"id": "a", "path": "python"}]}), 1.0)]


# ---------------------------------------------------------------------------
# the CLI views
# ---------------------------------------------------------------------------


def _fleet_parts() -> list[dict]:
    rng = np.random.default_rng(12)
    parts = []
    for k, machine in enumerate(("A", "B")):
        wall, hlc = _stamps(30, SKEW_NS * k)
        replicas = {}
        for j in range(2):
            replicas[f"llm{k}{j}"] = {
                "fingerprint": "f00d" * 4 if j == 0 else f"{k}{j}ab" * 4, "window": 8,
                "spec_k": 4 * j, "kv_dtype": "int8" if j else "fp", "weight_bits": 8,
                "model_id": "qwen2-1.5b", "free_streams": int(rng.integers(0, 16)),
                "used_pages": int(rng.integers(0, 512)), "total_pages": 512,
                "prefix_pages": int(rng.integers(0, 64)),
                "prefixes": [[f"h{i}", 32] for i in range(int(rng.integers(0, 4)))],
                "adapters": ["t0", "t1"][: int(rng.integers(0, 3))],
                "recv_wall_ns": wall - int(rng.integers(0, 9_000_000_000)),
            }
        parts.append({"machine_id": machine, "wall_ns": wall, "hlc_ns": hlc,
                      "replicas": replicas})
    return parts


def test_views_render_as_jax(tmp_path, monkeypatch):
    """``metrics`` (one frame and a --watch frame with the ring's rates),
    ``top``, ``fleet`` and ``alerts`` on the same merged inputs: the same
    text."""
    from dora_tpu import fleet as jfleet
    from dora_tpu_torch import fleet as pfleet

    monkeypatch.setattr(time, "time", lambda: T0_NS / 1e9 + 80.0)
    snaps_a, snaps_b = snapshots(13, 30, node="tts"), snapshots(14, 30)
    _, ticks, _ = _run_engine(jalerts, jhist, POLICY, tmp_path, "v", snaps_b)
    status = {**ticks[-1][1], "machine_id": "B"}
    merged = jmetrics.merge_snapshots([snaps_a[-1], {**snaps_b[-1], "alerts": status}])
    prev = jmetrics.merge_snapshots([snaps_a[-2], snaps_b[-2]])
    history = jhist.merge_history_snapshots(_machine_snapshots(jhist, 13))
    uuid = "0192-test"
    for kw in ({}, {"prev": prev, "interval": 2.0, "history": [prev, merged]},
               {"prev": prev, "interval": 2.0, "history": [prev], "rates": history["rates"]}):
        assert pmetrics_view.render_metrics(uuid, merged, **kw) == \
            jmetrics_view.render_metrics(uuid, merged, **kw)
    assert ptop_view.render_top(uuid, merged, history) == jtop_view.render_top(uuid, merged,
                                                                               history)
    assert ptop_view.render_top(uuid, {}, {}) == jtop_view.render_top(uuid, {}, {})
    fleet = jfleet.merge_fleet_snapshots(_fleet_parts())
    assert pfleet.merge_fleet_snapshots(_fleet_parts()) == fleet
    assert pfleet_view.render_fleet(uuid, fleet) == jfleet_view.render_fleet(uuid, fleet)
    assert pfleet_view.render_fleet(uuid, {}) == jfleet_view.render_fleet(uuid, {})
    block = snaps_b[-1]["fleet"]
    assert pfleet_view.render_fleet_panel(block) == jfleet_view.render_fleet_panel(block)
    with_fleet = {**merged, "fleet": block}
    assert ptop_view.render_top(uuid, with_fleet, history) == \
        jtop_view.render_top(uuid, with_fleet, history)
    alerts = palerts.merge_alert_status([status])
    text = palerts_view.render_alerts(uuid, alerts)
    assert text == jalerts_view.render_alerts(uuid, alerts)
    assert "firing" in text or "pending" in text or "ok" in text
    assert palerts_view.render_alerts_panel(alerts) == jalerts_view.render_alerts_panel(alerts)
    assert palerts_view.render_alerts(uuid, {}) == jalerts_view.render_alerts(uuid, {})


# ---------------------------------------------------------------------------
# the Prometheus exposition
# ---------------------------------------------------------------------------


def test_exposition_equals_jax(tmp_path):
    """``render_exposition`` of two dataflows' merged snapshots (serving,
    SLO burn, logs, trace drops, fleet and alert blocks): the same text, and
    both self-checks clean."""
    from dora_tpu import prom as jprom
    from dora_tpu_torch import prom as pprom

    ring, _ = _fill(jhist, snapshots(15, 30))
    _, ticks, _ = _run_engine(jalerts, jhist, POLICY, tmp_path, "p", snapshots(15, 30))
    serve = jmetrics.merge_snapshots([snapshots(15, 30)[-1], {
        **snapshots(16, 30, node="tts")[-1], "slo": ring.slo_status(), "alerts": ticks[-1][1]}])
    cluster = {"serve": serve, "0192-other": jmetrics.merge_snapshots(snapshots(17, 3))}
    text = pprom.render_exposition(cluster)
    assert text == jprom.render_exposition(cluster)
    assert list(pprom.iter_samples(cluster)) == list(jprom.iter_samples(cluster))
    assert pprom.validate_exposition(text) == [] == jprom.validate_exposition(text)
    assert 'dora_serving_requests_total{dataflow="serve",node="llm"}' in text
    assert pprom.self_check() == [] and pprom.FAMILIES == jprom.FAMILIES
    assert pprom.render_exposition({}) == jprom.render_exposition({})
    bad = text.replace("# TYPE dora_link_msgs_total counter\n", "")
    assert pprom.validate_exposition(bad) == jprom.validate_exposition(bad) != []
