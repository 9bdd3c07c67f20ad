"""Prometheus text exposition for the cluster metrics plane (the port's copy
of dora_tpu/prom.py: the same families, labels and text).

The coordinator serves this on ``DORA_PROM_PORT`` (``GET /metrics``):
every running (and still-reachable archived) dataflow's merged snapshot
(``dora_tpu_torch.metrics.merge_snapshots`` output, SLO block included) is
flattened into stable metric families with stable labels, rendered in
text exposition format 0.0.4. (The JAX package's OTLP push reads the same
sample iterator; the port has no OTLP push.) ``dora_serving_compiles_total``
keeps the JAX family's name and help; the port's node counts its engine's
CUDA-graph captures in it.

``validate_exposition`` is an offline linter over the rendered text —
metric/label name charset, TYPE lines, escaping, duplicate series — and
``self_check`` renders a synthetic cluster and lints it, mirroring
``tracing.self_check`` (the ``trace --check`` pattern): a bad rename
fails tier-1, not a scrape.
"""

from __future__ import annotations

import re
from typing import Any, Iterator

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: family name -> (type, help). Every sample iter_samples can yield must
#: be registered here — render and lint both key off this table.
FAMILIES: dict[str, tuple[str, str]] = {
    "dora_link_msgs_total": ("counter", "Messages routed per (sender, output) link"),
    "dora_link_bytes_total": ("counter", "Bytes routed per (sender, output) link"),
    "dora_drops_total": ("counter", "Inputs dropped (queue full, drop-oldest) per (node, input)"),
    "dora_queue_depth": ("gauge", "Live input queue depth per (node, input)"),
    "dora_fastroute_hits_total": ("counter", "Wire fast-path routed messages"),
    "dora_fastroute_fallbacks_total": ("counter", "Reflective-route fallbacks"),
    "dora_input_latency_us": ("gauge", "Send-to-deliver latency percentiles per (node, input)"),
    "dora_respawns_total": ("counter", "Node respawns (restart policy) per node"),
    "dora_replayed_inputs_total": ("counter", "Un-acked inputs replayed across respawns per node"),
    "dora_serving_requests_total": ("counter", "Serving requests admitted"),
    "dora_serving_rejected_total": ("counter", "Serving requests rejected at admission"),
    "dora_serving_decode_tokens_total": ("counter", "Decode tokens emitted"),
    "dora_serving_prefill_chunks_total": ("counter", "Prefill chunks dispatched"),
    "dora_serving_host_dispatches_total": ("counter", "Engine device-program launches"),
    "dora_serving_compiles_total": ("counter", "XLA compiles observed in the serving process"),
    "dora_serving_slots_active": ("gauge", "Engine slots currently decoding"),
    "dora_serving_slots_total": ("gauge", "Engine slot capacity"),
    "dora_serving_used_pages": ("gauge", "KV pages in use"),
    "dora_serving_free_pages": ("gauge", "KV pages free"),
    "dora_serving_total_pages": ("gauge", "KV page-pool capacity"),
    "dora_serving_backlog_depth": ("gauge", "Requests parked in the admission backlog"),
    "dora_serving_ttft_us": ("gauge", "Time-to-first-token percentiles"),
    "dora_slo_burn_rate": ("gauge", "Fraction of the SLO error budget consumed over the window"),
    "dora_slo_violations_total": ("counter", "SLO-violating history samples per node"),
    "dora_slo_burn_window_complete": ("gauge", "1 when the burn window holds a full complement of samples (partial-window burn is noisy)"),
    "dora_serving_shed_total": ("counter", "Requests shed on overload (depth bound / queue-wait deadline)"),
    "dora_serving_preempted_total": ("counter", "Streams evicted by QoS page preemption"),
    "dora_serving_resumed_total": ("counter", "Preempted streams re-admitted (recompute-on-resume)"),
    "dora_serving_retunes_total": ("counter", "Fused-window K retunes applied by the SLO autotuner"),
    "dora_serving_qos_depth": ("gauge", "Admission-backlog depth per QoS class"),
    "dora_serving_autotune_k": ("gauge", "Live fused-window K (decode ticks per dispatch)"),
    "dora_serving_prefix_hits_total": ("counter", "Admissions that mapped cached prefix pages"),
    "dora_serving_prefix_misses_total": ("counter", "Admissions with no usable cached prefix"),
    "dora_serving_prefix_hit_tokens_total": ("counter", "Prompt tokens served from the prefix cache"),
    "dora_serving_prefix_cow_copies_total": ("counter", "Copy-on-write boundary pages re-materialized"),
    "dora_serving_prefix_evictions_total": ("counter", "Cached prefix pages evicted under pool pressure"),
    "dora_serving_prefix_cached_pages": ("gauge", "KV pages held by the radix prefix cache"),
    "dora_serving_prefix_shared_pages": ("gauge", "Cached pages currently mapped shared into live streams"),
    "dora_serving_kv_int8": ("gauge", "1 when the paged KV pool is int8 (quantized serving), 0 for fp"),
    "dora_serving_kv_pool_bytes": ("gauge", "Total device bytes of the paged KV pool including scale planes"),
    "dora_serving_kv_quant_err": ("gauge", "Mean relative quantization step over sampled allocated int8 KV pages (0 for fp pools)"),
    "dora_tpu_mfu": ("gauge", "Model FLOPs utilization: useful (emitted-token) FLOP/s over device peak"),
    "dora_tpu_device_busy_fraction": ("gauge", "Fraction of wall time the device spent computing dispatched windows"),
    "dora_tpu_device_hbm_used_bytes": ("gauge", "Device allocator bytes in use (0 when the backend exposes no memory stats)"),
    "dora_tpu_device_hbm_limit_bytes": ("gauge", "Device allocator byte limit"),
    "dora_tpu_device_hbm_peak_bytes": ("gauge", "Device allocator peak bytes in use"),
    "dora_tpu_device_compute_ns_total": ("counter", "Device-compute nanoseconds attributed across fused windows and final prefill chunks"),
    "dora_tpu_device_host_dispatch_ns_total": ("counter", "Host-side dispatch nanoseconds before each device launch"),
    "dora_tpu_device_fetch_ns_total": ("counter", "Device-to-host fetch nanoseconds after each window"),
    "dora_tpu_device_flops_total": ("counter", "Useful FLOPs: emitted tokens x analytic per-token model"),
    "dora_tpu_device_dispatched_flops_total": ("counter", "Dispatched FLOPs including frozen rows and rejected speculative tails"),
    "dora_serving_lora_resident": ("gauge", "LoRA adapters resident in the device pool"),
    "dora_serving_lora_max_resident": ("gauge", "Resident-adapter pool capacity"),
    "dora_serving_lora_resident_bytes": ("gauge", "Device bytes held by resident LoRA adapters"),
    "dora_serving_lora_loads_total": ("counter", "LoRA adapters loaded into the resident pool"),
    "dora_serving_lora_evictions_total": ("counter", "LoRA adapters evicted from the resident pool (LRU)"),
    "dora_serving_adapter_streams": ("gauge", "Live streams pinned per resident LoRA adapter"),
    "dora_serving_adapter_stalls_total": ("counter", "Backlog entries parked because the requested LoRA adapter cannot become resident"),
    "dora_node_log_errors_total": ("counter", "Error-level log lines per node (level-prefix parsed)"),
    "dora_node_log_warns_total": ("counter", "Warn-level log lines per node (level-prefix parsed)"),
    "dora_trace_dropped_events_total": ("counter", "Flight-recorder events lost to ring truncation per process"),
    "dora_fleet_digest_age_s": ("gauge", "Seconds since the replica's last engine-state digest reached its daemon"),
    "dora_fleet_free_streams": ("gauge", "fits()-derived streams the replica could admit right now"),
    "dora_fleet_occupancy": ("gauge", "KV page-pool occupancy fraction (used/total) per replica"),
    "dora_fleet_prefix_pages": ("gauge", "KV pages held by the replica's radix prefix cache at digest time"),
    "dora_alerts": ("gauge", "Active alert instances: 1 per (alertname, instance) in state pending or firing"),
    "dora_alert_firing_total": ("counter", "Pending-to-firing transitions per alert rule"),
    "dora_alert_resolved_total": ("counter", "Firing-to-resolved transitions per alert rule"),
}

#: (snapshot serving key, metric family) pairs for the per-node scalars
_SERVING_COUNTERS = (
    ("requests", "dora_serving_requests_total"),
    ("rejected", "dora_serving_rejected_total"),
    ("decode_tokens", "dora_serving_decode_tokens_total"),
    ("prefill_chunks", "dora_serving_prefill_chunks_total"),
    ("host_dispatches", "dora_serving_host_dispatches_total"),
    ("compiles", "dora_serving_compiles_total"),
    ("shed", "dora_serving_shed_total"),
    ("preempted", "dora_serving_preempted_total"),
    ("resumed", "dora_serving_resumed_total"),
    ("retunes", "dora_serving_retunes_total"),
    ("prefix_hits", "dora_serving_prefix_hits_total"),
    ("prefix_misses", "dora_serving_prefix_misses_total"),
    ("prefix_hit_tokens", "dora_serving_prefix_hit_tokens_total"),
    ("prefix_cow_copies", "dora_serving_prefix_cow_copies_total"),
    ("prefix_evictions", "dora_serving_prefix_evictions_total"),
    ("device_compute_ns", "dora_tpu_device_compute_ns_total"),
    ("host_dispatch_ns", "dora_tpu_device_host_dispatch_ns_total"),
    ("device_fetch_ns", "dora_tpu_device_fetch_ns_total"),
    ("useful_flops", "dora_tpu_device_flops_total"),
    ("dispatched_flops", "dora_tpu_device_dispatched_flops_total"),
    ("lora_loads", "dora_serving_lora_loads_total"),
    ("lora_evictions", "dora_serving_lora_evictions_total"),
    ("adapter_stalls", "dora_serving_adapter_stalls_total"),
)
_SERVING_GAUGES = (
    ("slots_active", "dora_serving_slots_active"),
    ("slots_total", "dora_serving_slots_total"),
    ("used_pages", "dora_serving_used_pages"),
    ("free_pages", "dora_serving_free_pages"),
    ("total_pages", "dora_serving_total_pages"),
    ("backlog_depth", "dora_serving_backlog_depth"),
    ("autotune_k", "dora_serving_autotune_k"),
    ("prefix_cached_pages", "dora_serving_prefix_cached_pages"),
    ("prefix_shared_pages", "dora_serving_prefix_shared_pages"),
    # Device utilization gauges: None (backend exposes no stats /
    # monitor off) exports as 0 via the `or 0` in iter_samples — prom
    # has no "absent" value; the CLIs render the dash instead.
    ("mfu", "dora_tpu_mfu"),
    ("device_busy_fraction", "dora_tpu_device_busy_fraction"),
    ("hbm_used_bytes", "dora_tpu_device_hbm_used_bytes"),
    ("hbm_limit_bytes", "dora_tpu_device_hbm_limit_bytes"),
    ("hbm_peak_bytes", "dora_tpu_device_hbm_peak_bytes"),
    ("kv_pool_bytes", "dora_serving_kv_pool_bytes"),
    ("kv_quant_err", "dora_serving_kv_quant_err"),
    ("lora_resident", "dora_serving_lora_resident"),
    ("lora_max_resident", "dora_serving_lora_max_resident"),
    ("lora_resident_bytes", "dora_serving_lora_resident_bytes"),
)


def iter_samples(
    snapshots: dict[str, dict],
) -> Iterator[tuple[str, dict[str, str], float]]:
    """``(family, labels, value)`` triples for every sample across all
    dataflows. ``snapshots`` maps the dataflow label (name or uuid) to
    its merged metrics snapshot."""
    for dataflow, snap in snapshots.items():
        base = {"dataflow": dataflow}
        for link, v in snap.get("links", {}).items():
            labels = {**base, "link": link}
            yield "dora_link_msgs_total", labels, v.get("msgs", 0)
            yield "dora_link_bytes_total", labels, v.get("bytes", 0)
        for key, c in snap.get("drops", {}).items():
            yield "dora_drops_total", {**base, "input": key}, c
        for key, d in snap.get("queue_depth", {}).items():
            yield "dora_queue_depth", {**base, "input": key}, d
        fr = snap.get("fastroute", {})
        yield "dora_fastroute_hits_total", base, fr.get("hits", 0)
        yield "dora_fastroute_fallbacks_total", base, fr.get("fallbacks", 0)
        for key, h in snap.get("latency_us", {}).items():
            for p in (50, 90, 99):
                value = h.get(f"p{p}_us")
                if value is None:
                    continue
                yield (
                    "dora_input_latency_us",
                    {**base, "input": key, "quantile": f"0.{p}"},
                    value,
                )
        recovery = snap.get("recovery") or {}
        for node, c in recovery.get("respawns", {}).items():
            yield "dora_respawns_total", {**base, "node": node}, c
        for node, c in recovery.get("replayed_inputs", {}).items():
            yield "dora_replayed_inputs_total", {**base, "node": node}, c
        for node, s in snap.get("serving", {}).items():
            labels = {**base, "node": node}
            for key, family in _SERVING_COUNTERS:
                yield family, labels, s.get(key, 0) or 0
            for key, family in _SERVING_GAUGES:
                yield family, labels, s.get(key, 0) or 0
            # kv_dtype is a string in the snapshot; prom values are
            # numeric, so it exports as a 0/1 int8 flag.
            yield (
                "dora_serving_kv_int8", labels,
                1 if s.get("kv_dtype") == "int8" else 0,
            )
            for cls, depth in (s.get("qos_depth") or {}).items():
                yield (
                    "dora_serving_qos_depth",
                    {**labels, "class": cls},
                    depth or 0,
                )
            for name, n in (s.get("adapter_streams") or {}).items():
                yield (
                    "dora_serving_adapter_streams",
                    {**labels, "adapter": name},
                    n or 0,
                )
            ttft = s.get("ttft_us") or {}
            for p in (50, 90, 99):
                value = ttft.get(f"p{p}_us")
                if value is not None:
                    yield (
                        "dora_serving_ttft_us",
                        {**labels, "quantile": f"0.{p}"},
                        value,
                    )
        for node, entry in snap.get("slo", {}).items():
            labels = {**base, "node": node}
            for window in ("1m", "10m"):
                yield (
                    "dora_slo_burn_rate",
                    {**labels, "window": window},
                    entry.get(f"burn_{window}", 0.0),
                )
                yield (
                    "dora_slo_burn_window_complete",
                    {**labels, "window": window},
                    1.0 if entry.get(f"burn_{window}_complete") else 0.0,
                )
            yield "dora_slo_violations_total", labels, entry.get("violations", 0)
        for node, counts in snap.get("logs", {}).items():
            labels = {**base, "node": node}
            yield "dora_node_log_errors_total", labels, counts.get("errors", 0)
            yield "dora_node_log_warns_total", labels, counts.get("warns", 0)
        for proc, c in (snap.get("trace") or {}).get("drops", {}).items():
            yield (
                "dora_trace_dropped_events_total",
                {**base, "process": proc},
                c,
            )
        for node, f in snap.get("fleet", {}).items():
            labels = {**base, "node": node}
            yield "dora_fleet_digest_age_s", labels, f.get("digest_age_s", 0) or 0
            yield "dora_fleet_free_streams", labels, f.get("free_streams", 0) or 0
            yield "dora_fleet_occupancy", labels, f.get("occupancy", 0) or 0
            yield "dora_fleet_prefix_pages", labels, f.get("prefix_pages", 0) or 0
        alerts = snap.get("alerts") or {}
        for name, entry in alerts.get("rules", {}).items():
            for instance, inst in (entry.get("instances") or {}).items():
                state = inst.get("state", "ok")
                if state == "ok":
                    # Only active series export — the Alertmanager
                    # convention (absence means not firing); resolved
                    # history lives in the _total counters below.
                    continue
                yield (
                    "dora_alerts",
                    {
                        **base,
                        "alertname": name,
                        "instance": instance,
                        "severity": entry.get("severity", "warning"),
                        "alertstate": state,
                    },
                    1,
                )
        for name, c in alerts.get("firing_total", {}).items():
            yield "dora_alert_firing_total", {**base, "alertname": name}, c
        for name, c in alerts.get("resolved_total", {}).items():
            yield "dora_alert_resolved_total", {**base, "alertname": name}, c


def escape_label_value(value: str) -> str:
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace("\n", "\\n")
        .replace('"', '\\"')
    )


def _format_value(value: float) -> str:
    f = float(value)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def render_exposition(snapshots: dict[str, dict]) -> str:
    """Render all dataflow snapshots as Prometheus text exposition.

    Families are emitted in registry order with their HELP/TYPE header,
    samples grouped under their family (the format requires it)."""
    by_family: dict[str, list[str]] = {}
    for family, labels, value in iter_samples(snapshots):
        pairs = ",".join(
            f'{k}="{escape_label_value(v)}"' for k, v in sorted(labels.items())
        )
        line = f"{family}{{{pairs}}} {_format_value(value)}"
        by_family.setdefault(family, []).append(line)
    out: list[str] = []
    for family, (ftype, help_text) in FAMILIES.items():
        lines = by_family.get(family)
        if not lines:
            continue
        out.append(f"# HELP {family} {help_text}")
        out.append(f"# TYPE {family} {ftype}")
        out.extend(lines)
    return "\n".join(out) + "\n" if out else ""


# ---------------------------------------------------------------------------
# lint (the `trace --check` pattern)
# ---------------------------------------------------------------------------

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?"
    r" (?P<value>[^ ]+)(?: (?P<ts>-?\d+))?$"
)
_LABEL_PAIR_RE = re.compile(
    r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"(?:,|$)'
)


def validate_exposition(text: str) -> list[str]:
    """Lint rendered exposition text; returns a list of problems (empty
    = valid). Checks the failure modes a scrape would reject: bad
    metric/label names, samples without a TYPE line, unparseable values,
    duplicate series, counters not ending in ``_total``."""
    problems: list[str] = []
    typed: dict[str, str] = {}
    seen_series: set[str] = set()
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# HELP ") or line.startswith("# TYPE "):
            parts = line.split(" ", 3)
            if len(parts) < 4 or not _NAME_RE.match(parts[2]):
                problems.append(f"line {lineno}: malformed comment: {line!r}")
                continue
            if parts[1] == "TYPE":
                if parts[2] in typed:
                    problems.append(
                        f"line {lineno}: duplicate TYPE for {parts[2]}"
                    )
                if parts[3] not in ("counter", "gauge", "histogram",
                                    "summary", "untyped"):
                    problems.append(
                        f"line {lineno}: bad type {parts[3]!r}"
                    )
                typed[parts[2]] = parts[3]
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            problems.append(f"line {lineno}: unparseable sample: {line!r}")
            continue
        name = m.group("name")
        if name not in typed:
            problems.append(f"line {lineno}: sample {name} has no TYPE line")
        elif typed[name] == "counter" and not name.endswith(
            ("_total", "_created")
        ):
            problems.append(
                f"line {lineno}: counter {name} should end in _total"
            )
        raw_labels = m.group("labels") or ""
        consumed = "".join(
            mm.group(0) for mm in _LABEL_PAIR_RE.finditer(raw_labels)
        )
        if raw_labels and len(consumed) != len(raw_labels):
            problems.append(
                f"line {lineno}: malformed labels: {raw_labels!r}"
            )
        label_names = [
            mm.group(1) for mm in _LABEL_PAIR_RE.finditer(raw_labels)
        ]
        if len(set(label_names)) != len(label_names):
            problems.append(f"line {lineno}: duplicate label name")
        for ln in label_names:
            if not _LABEL_RE.match(ln) or ln.startswith("__"):
                problems.append(f"line {lineno}: bad label name {ln!r}")
        try:
            float(m.group("value"))
        except ValueError:
            problems.append(
                f"line {lineno}: unparseable value {m.group('value')!r}"
            )
        series = f"{name}{{{raw_labels}}}"
        if series in seen_series:
            problems.append(f"line {lineno}: duplicate series {series}")
        seen_series.add(series)
    return problems


def _sample_snapshots() -> dict[str, dict[str, Any]]:
    """A synthetic two-dataflow cluster exercising every family,
    including the label-escaping edge cases."""
    from dora_tpu_torch.metrics import Histogram

    hist = Histogram()
    for us in (120.0, 900.0, 15000.0):
        hist.observe(us)
    return {
        "camera-vlm": {
            "links": {'cam/img "hd"': {"msgs": 120, "bytes": 1 << 20}},
            "drops": {"plot/img": 3},
            "queue_depth": {"plot/img": 2},
            "fastroute": {"hits": 110, "fallbacks": 10},
            "latency_us": {"plot/img": hist.snapshot()},
            "recovery": {
                "respawns": {"plot": 1},
                "replayed_inputs": {"plot": 4},
            },
            "serving": {
                "llm": {
                    "requests": 42,
                    "rejected": 2,
                    "decode_tokens": 4096,
                    "prefill_chunks": 12,
                    "host_dispatches": 512,
                    "compiles": 7,
                    "shed": 5,
                    "preempted": 2,
                    "resumed": 2,
                    "retunes": 1,
                    "slots_active": 3,
                    "slots_total": 4,
                    "used_pages": 48,
                    "free_pages": 16,
                    "total_pages": 64,
                    "backlog_depth": 1,
                    "autotune_k": 8,
                    "prefix_hits": 30,
                    "prefix_misses": 12,
                    "prefix_hit_tokens": 960,
                    "prefix_cow_copies": 4,
                    "prefix_evictions": 6,
                    "prefix_cached_pages": 20,
                    "prefix_shared_pages": 9,
                    "device_compute_ns": 900_000_000,
                    "host_dispatch_ns": 80_000_000,
                    "device_fetch_ns": 20_000_000,
                    "useful_flops": 4_096_000_000,
                    "dispatched_flops": 16_384_000_000,
                    "mfu": 0.41,
                    "device_busy_fraction": 0.9,
                    "hbm_used_bytes": 12 << 30,
                    "hbm_limit_bytes": 16 << 30,
                    "hbm_peak_bytes": 13 << 30,
                    "kv_dtype": "int8",
                    "kv_pool_bytes": 2 << 30,
                    "kv_quant_err": 0.004,
                    "qos_depth": {"interactive": 0, "standard": 1, "batch": 3},
                    "lora_resident": 2,
                    "lora_max_resident": 8,
                    "lora_resident_bytes": 64 << 20,
                    "lora_loads": 9,
                    "lora_evictions": 7,
                    "adapter_stalls": 3,
                    "adapter_streams": {"tenant-a": 2, 'b "quoted"': 1},
                    "ttft_us": hist.snapshot(),
                }
            },
            "fleet": {
                "llm": {
                    "digest_age_s": 1.4,
                    "free_streams": 2,
                    "used_pages": 48,
                    "total_pages": 64,
                    "occupancy": 0.75,
                    "prefix_pages": 20,
                    "seq": 9,
                }
            },
            "logs": {"llm": {"errors": 2, "warns": 5}},
            "trace": {"drops": {"llm": 17}},
            "alerts": {
                "rules": {
                    "queue-depth": {
                        "severity": "warning",
                        "labels": {"team": "serving"},
                        "threshold": 256,
                        "instances": {
                            "plot/img": {
                                "state": "firing",
                                "value": 300.0,
                                "since_unix": 1_700_000_000.0,
                                "incidents": 1,
                            },
                            "cam/img": {
                                "state": "ok",
                                "value": 2.0,
                                "since_unix": 1_700_000_100.0,
                                "incidents": 0,
                            },
                        },
                    },
                    "shed-spike": {
                        "severity": "critical",
                        "labels": {},
                        "threshold": 0.5,
                        "instances": {
                            "llm": {
                                "state": "pending",
                                "value": 0.8,
                                "since_unix": 1_700_000_200.0,
                                "incidents": 0,
                            },
                        },
                    },
                },
                "firing": 1,
                "pending": 1,
                "transitions": {"pending": 2, "firing": 1, "resolved": 1},
                "firing_total": {"queue-depth": 1},
                "resolved_total": {"shed-spike": 1},
            },
            "slo": {
                "llm": {
                    "targets": {"ttft_p99_ms": 50.0},
                    "burn_1m": 0.25,
                    "burn_1m_complete": True,
                    "burn_10m": 0.05,
                    "burn_10m_complete": False,
                    "violations": 3,
                }
            },
        },
        "bench\nrun\\2": {
            "links": {"a/out": {"msgs": 5, "bytes": 100}},
            "drops": {},
            "queue_depth": {},
            "fastroute": {"hits": 0, "fallbacks": 0},
            "latency_us": {},
        },
    }


def self_check() -> list[str]:
    """Render the synthetic cluster and lint it — the tier-1 guard (and
    ``dora-tpu metrics --check-prom``) that catches a bad rename before
    a scrape does."""
    problems = validate_exposition(render_exposition(_sample_snapshots()))
    for family in FAMILIES:
        if not _NAME_RE.match(family) or not family.startswith("dora_"):
            problems.append(f"bad family name {family!r}")
    return problems
