"""Retained metrics time series: per-dataflow history rings + merge (the
port's copy of dora_tpu/metrics_history.py; the serving node reads only
:func:`burn_window_complete`, the daemon the ring, the coordinator the merge).

The snapshot plane (``dora_tpu_torch.metrics``) answers "what are the counters
now"; this module answers "what happened over the last hour". Each daemon
samples its merged dataflow snapshot (``Daemon.metrics_snapshot``) on a
fixed cadence (``DORA_METRICS_HISTORY_S``, default 5 s) into a bounded
:class:`MetricsHistoryRing` — fixed capacity, oldest-overwritten, wrap
losses counted, the allocation discipline of ``telemetry.FlightRecorder``.

Samples are **delta encoded**: cumulative counters and histogram bucket
counts are differenced against the previous sample, so a ring slot holds
only what changed in that interval and rate/percentile math downstream is
a division, not a diff of two snapshots the caller happens to hold.
Counter resets (a respawned node re-reporting from zero) are detected
here — a negative delta stores the new cumulative value as the delta and
bumps a per-key reset counter — so consumers never see negative rates.

``merge_history_snapshots`` aligns per-machine rings onto the cluster
timeline using the same HLC-offset trick as the trace merge
(``tracing.merge_trace_snapshots``): each ring snapshot carries a
``(wall_ns, hlc_ns)`` pair captured together; ``hlc_ns - wall_ns`` is the
machine's clock offset and shifting every sample's wall stamp by it puts
all machines on one comparable axis. It also derives the server-side
series the CLI/autotuner consume: per-key rates, windowed histogram
percentiles, and SLO burn.

SLO targets (descriptor ``slo:`` block, ``core.descriptor.SloPolicy``)
are evaluated per sample against the interval's deltas; a violation is
flagged in the slot and surfaced as burn-rate gauges — the fraction of
the error budget (every sample in the window being in-target) consumed
over 1 m / 10 m windows.
"""

from __future__ import annotations

import os
from typing import Any

from dora_tpu_torch.metrics import HISTOGRAM_BUCKETS, percentile_from_counts

#: Default sampling cadence (seconds); 0 disables sampling entirely.
DEFAULT_INTERVAL_S = 5.0
#: Default ring capacity: 720 samples = 1 h at the default 5 s cadence.
DEFAULT_CAPACITY = 720
#: Derived rates/percentiles are computed over a trailing window of at
#: most this many seconds of aligned samples (matches the 1 m burn window).
RATE_WINDOW_S = 60.0

#: SLO objective names (descriptor keys, burn-gauge labels).
SLO_OBJECTIVES = ("ttft_p99_ms", "tokens_per_s_min", "queue_depth_max")


def history_interval_s() -> float:
    """``DORA_METRICS_HISTORY_S`` (seconds between samples; <=0 disables)."""
    raw = os.environ.get("DORA_METRICS_HISTORY_S", "")
    if raw == "":
        return DEFAULT_INTERVAL_S
    try:
        return float(raw)
    except ValueError:
        return DEFAULT_INTERVAL_S


def history_capacity() -> int:
    """``DORA_METRICS_HISTORY_LEN`` (ring slots; default 720 ≈ 1 h @ 5 s)."""
    try:
        return max(2, int(os.environ.get("DORA_METRICS_HISTORY_LEN", "")
                          or DEFAULT_CAPACITY))
    except ValueError:
        return DEFAULT_CAPACITY


def flatten_snapshot(snap: dict) -> tuple[dict, dict, dict]:
    """Flatten a ``metrics_snapshot`` dict into flat series keys.

    Returns ``(counters, gauges, hists)``:

    * counters — cumulative monotonic values (``link:a/out:msgs``,
      ``drop:b/in``, ``fastroute:hits``, ``respawn:a``,
      ``srv:llm:decode_tokens`` …),
    * gauges — instantaneous values (``queue:b/in``,
      ``srv:llm:used_pages`` …),
    * hists — cumulative histogram bucket-count lists (``lat:b/in``,
      ``srv:llm:ttft_us``).
    """
    counters: dict[str, float] = {}
    gauges: dict[str, float] = {}
    hists: dict[str, list[int]] = {}
    for key, v in snap.get("links", {}).items():
        counters[f"link:{key}:msgs"] = v.get("msgs", 0)
        counters[f"link:{key}:bytes"] = v.get("bytes", 0)
    for key, c in snap.get("drops", {}).items():
        counters[f"drop:{key}"] = c
    fr = snap.get("fastroute", {})
    counters["fastroute:hits"] = fr.get("hits", 0)
    counters["fastroute:fallbacks"] = fr.get("fallbacks", 0)
    recovery = snap.get("recovery") or {}
    for node, c in recovery.get("respawns", {}).items():
        counters[f"respawn:{node}"] = c
    for node, c in recovery.get("replayed_inputs", {}).items():
        counters[f"replay:{node}"] = c
    for key, d in snap.get("queue_depth", {}).items():
        gauges[f"queue:{key}"] = d
    for key, h in snap.get("latency_us", {}).items():
        hists[f"lat:{key}"] = list(h.get("counts", []))
    # Structured log severity: per-node stderr/stdout ERROR and WARN
    # line counts (daemon-side parse; alerting's log-error-rate rule).
    for node, c in snap.get("logs", {}).items():
        counters[f"logerr:{node}"] = c.get("errors", 0)
        counters[f"logwarn:{node}"] = c.get("warns", 0)
    # Trace-plane truncation: node events the daemon-side buffer cap
    # trimmed (the trace-truncated alert watches this rate).
    for node, c in (snap.get("trace") or {}).get("drops", {}).items():
        counters[f"tracedrop:{node}"] = c
    for node, s in snap.get("serving", {}).items():
        for name in ("decode_tokens", "requests", "rejected",
                     "prefill_chunks", "host_dispatches", "compiles",
                     "spec_drafted", "spec_accepted",
                     "shed", "preempted", "resumed", "retunes",
                     "prefix_hits", "prefix_misses", "prefix_hit_tokens",
                     "prefix_cow_copies", "prefix_evictions",
                     "device_compute_ns", "host_dispatch_ns",
                     "device_fetch_ns", "dispatched_flops",
                     "useful_flops", "lora_loads", "lora_evictions",
                     "adapter_stalls"):
            counters[f"srv:{node}:{name}"] = s.get(name, 0)
        for name in ("slots_active", "slots_total", "used_pages",
                     "total_pages", "free_pages", "backlog_depth",
                     "autotune_k", "prefix_cached_pages",
                     "prefix_shared_pages", "lora_resident",
                     "lora_max_resident", "lora_resident_bytes"):
            gauges[f"srv:{node}:{name}"] = s.get(name, 0)
        # Device utilization gauges are None when unknown (CPU backend,
        # monitor off, pre-round-16 snapshot): recorded only when real,
        # so history series never fabricate a zero-MFU sample.
        # checkpoint_age_s rides along: derived (non-monotonic) but a
        # gauge like the rest, None until the first checkpoint lands —
        # the checkpoint-stale alert reads it from here.
        for name in ("mfu", "device_busy_fraction", "hbm_used_bytes",
                     "hbm_limit_bytes", "hbm_peak_bytes",
                     "kv_pool_bytes", "kv_quant_err", "checkpoint_age_s"):
            if s.get(name) is not None:
                gauges[f"srv:{node}:{name}"] = s[name]
        # kv_dtype is a string gauge; series store its 0/1 projection
        # (same encoding as the dora_serving_kv_int8 prom family).
        if s.get("kv_dtype") is not None:
            gauges[f"srv:{node}:kv_int8"] = (
                1 if s["kv_dtype"] == "int8" else 0
            )
        for cls, d in (s.get("qos_depth") or {}).items():
            gauges[f"srv:{node}:qos_depth:{cls}"] = d
        for name, n in (s.get("adapter_streams") or {}).items():
            gauges[f"srv:{node}:adapter_streams:{name}"] = n
        ttft = s.get("ttft_us") or {}
        hists[f"srv:{node}:ttft_us"] = list(ttft.get("counts", []))
    # Fleet plane: the per-replica digest-derived gauge block
    # (daemon metrics_snapshot["fleet"], dora_tpu_torch.fleet.fleet_gauges).
    # The `fleet-digest-stale` default alert rule watches digest_age_s.
    for node, f in snap.get("fleet", {}).items():
        for name in ("digest_age_s", "free_streams", "used_pages",
                     "total_pages", "occupancy", "prefix_pages"):
            if f.get(name) is not None:
                gauges[f"fleet:{node}:{name}"] = f[name]
    return counters, gauges, hists


def burn_window_complete(n_samples: int, window_s: float,
                         interval_s: float) -> bool:
    """Does ``n_samples`` retained samples cover a full ``window_s``
    burn window at ``interval_s`` cadence? Burn gauges computed over a
    PARTIAL window are noisy (KNOWN_ISSUES round 9: a freshly started
    dataflow reports burn over a 3-sample prefix) — consumers that act
    on burn (the llm_server K autotuner) and the
    ``dora_slo_burn_window_complete`` prom gauge gate on this."""
    if interval_s <= 0:
        return False
    return n_samples >= max(1, round(window_s / interval_s))


class MetricsHistoryRing:
    """Bounded per-dataflow time series of delta-encoded samples.

    Slots are preallocated and overwritten in place on wrap (wrap losses
    counted in ``dropped``), mirroring ``FlightRecorder``. ``sample()``
    is called from the daemon's sampler task; everything else reads.
    """

    # slot layout (parallel to FlightRecorder's positional slots)
    WALL, HLC, COUNTERS, GAUGES, HIST, SLO = range(6)

    __slots__ = (
        "capacity", "interval_s", "slo_targets", "_slots", "_idx",
        "dropped", "resets", "_last_counters", "_last_hists",
        "_last_wall_ns", "violation_total",
    )

    def __init__(
        self,
        capacity: int | None = None,
        interval_s: float | None = None,
        slo_targets: dict[str, dict] | None = None,
    ):
        self.capacity = capacity if capacity is not None else history_capacity()
        self.interval_s = (
            interval_s if interval_s is not None else history_interval_s()
        )
        #: node id -> {objective: target} (descriptor ``slo:`` blocks)
        self.slo_targets = dict(slo_targets or {})
        self._slots: list[list] = [
            [0, 0, None, None, None, None] for _ in range(self.capacity)
        ]
        self._idx = 0
        self.dropped = 0
        #: series key -> counter-reset count (respawn re-reports, …)
        self.resets: dict[str, int] = {}
        self._last_counters: dict[str, float] = {}
        self._last_hists: dict[str, list[int]] = {}
        self._last_wall_ns = 0
        #: (node, objective) -> total violating samples since spawn
        self.violation_total: dict[tuple[str, str], int] = {}

    def __len__(self) -> int:
        return min(self._idx, self.capacity)

    # -- write --------------------------------------------------------------

    def sample(
        self, snap: dict, wall_ns: int, hlc_ns: int
    ) -> list[tuple[str, str, float, float]]:
        """Delta-encode one snapshot into the ring.

        Returns newly-detected SLO violations as
        ``(node, objective, observed, target)`` tuples — the caller
        records them as flight-recorder instants."""
        counters, gauges, hists = flatten_snapshot(snap)
        dt_s = (
            (wall_ns - self._last_wall_ns) / 1e9
            if self._last_wall_ns
            else self.interval_s
        )
        c_delta: dict[str, float] = {}
        for key, cur in counters.items():
            d = cur - self._last_counters.get(key, 0)
            if d < 0:  # counter reset: treat the new cumulative as the delta
                self.resets[key] = self.resets.get(key, 0) + 1
                d = cur
            if d:
                c_delta[key] = d
        h_delta: dict[str, list[int]] = {}
        for key, cur_counts in hists.items():
            prev = self._last_hists.get(key)
            if prev is None or len(prev) != len(cur_counts):
                d = list(cur_counts)
            else:
                d = [c - p for c, p in zip(cur_counts, prev)]
                if any(x < 0 for x in d):
                    self.resets[key] = self.resets.get(key, 0) + 1
                    d = list(cur_counts)
            if any(d):
                h_delta[key] = d
        slo_flags, events = self._evaluate_slo(c_delta, gauges, h_delta, dt_s)

        if self._idx >= self.capacity:
            self.dropped += 1
        slot = self._slots[self._idx % self.capacity]
        slot[self.WALL] = wall_ns
        slot[self.HLC] = hlc_ns
        slot[self.COUNTERS] = c_delta
        slot[self.GAUGES] = gauges
        slot[self.HIST] = h_delta
        slot[self.SLO] = slo_flags or None
        self._idx += 1
        self._last_counters = counters
        self._last_hists = hists
        self._last_wall_ns = wall_ns
        return events

    def _evaluate_slo(
        self,
        c_delta: dict[str, float],
        gauges: dict[str, float],
        h_delta: dict[str, list[int]],
        dt_s: float,
    ) -> tuple[dict, list[tuple[str, str, float, float]]]:
        """Check this interval's deltas against the targets.

        Returns ``({node: {objective: observed}}, [(node, objective,
        observed, target), ...])`` for the violating objectives only."""
        flags: dict[str, dict[str, float]] = {}
        events: list[tuple[str, str, float, float]] = []

        def _hit(node: str, objective: str, observed: float, target: float):
            flags.setdefault(node, {})[objective] = observed
            key = (node, objective)
            self.violation_total[key] = self.violation_total.get(key, 0) + 1
            events.append((node, objective, observed, target))

        for node, targets in self.slo_targets.items():
            target = targets.get("ttft_p99_ms")
            if target is not None:
                counts = h_delta.get(f"srv:{node}:ttft_us")
                if counts:
                    p99 = percentile_from_counts(counts, 99)
                    if p99 is not None and p99 > target * 1000.0:
                        _hit(node, "ttft_p99_ms", round(p99 / 1000.0, 3),
                             target)
            target = targets.get("tokens_per_s_min")
            if target is not None and dt_s > 0:
                toks = c_delta.get(f"srv:{node}:decode_tokens", 0)
                active = gauges.get(f"srv:{node}:slots_active", 0)
                # Only a floor while the engine is actually decoding —
                # an idle server is not "missing" its throughput target.
                if toks or active:
                    rate = toks / dt_s
                    if rate < target:
                        _hit(node, "tokens_per_s_min", round(rate, 2), target)
            target = targets.get("queue_depth_max")
            if target is not None:
                prefix = f"queue:{node}/"
                depth = max(
                    (v for k, v in gauges.items() if k.startswith(prefix)),
                    default=None,
                )
                backlog = gauges.get(f"srv:{node}:backlog_depth")
                if backlog is not None:
                    depth = max(depth or 0, backlog)
                if depth is not None and depth > target:
                    _hit(node, "queue_depth_max", depth, target)
        return flags, events

    # -- read ---------------------------------------------------------------

    def samples(self) -> list[list]:
        """Filled slots, oldest first (slot lists, not copies)."""
        start = max(0, self._idx - self.capacity)
        return [self._slots[i % self.capacity] for i in range(start, self._idx)]

    def slo_status(self) -> dict:
        """Burn-rate gauges per node: fraction of the error budget
        consumed over the trailing 1 m / 10 m windows (1.0 = every sample
        in the window violated at least one objective)."""
        if not self.slo_targets:
            return {}
        samples = self.samples()
        interval = self.interval_s or DEFAULT_INTERVAL_S
        out: dict[str, dict] = {}
        for node, targets in self.slo_targets.items():
            entry: dict[str, Any] = {"targets": dict(targets)}
            for label, window_s in (("burn_1m", 60.0), ("burn_10m", 600.0)):
                n = max(1, round(window_s / interval))
                window = samples[-n:]
                # Partial windows still report burn (over the prefix)
                # but flag incompleteness so consumers — the autotuner,
                # alerting off dora_slo_burn_rate — can ignore the
                # noisy early gauges (KNOWN_ISSUES round 9).
                entry[f"{label}_complete"] = burn_window_complete(
                    len(window), window_s, interval
                )
                if not window:
                    entry[label] = 0.0
                    continue
                bad = sum(
                    1 for s in window
                    if s[self.SLO] and node in s[self.SLO]
                )
                entry[label] = round(bad / len(window), 4)
            entry["violations"] = sum(
                c for (n_, _), c in self.violation_total.items() if n_ == node
            )
            last = next(
                (s[self.SLO][node] for s in reversed(samples)
                 if s[self.SLO] and node in s[self.SLO]),
                None,
            )
            if last:
                entry["last"] = dict(last)
            out[node] = entry
        return out

    def snapshot(self) -> dict:
        """JSON-able ring export (one daemon's view; the coordinator adds
        the machine id and the ``(wall_ns, hlc_ns)`` alignment pair is
        captured by the daemon at export time)."""
        return {
            "interval_s": self.interval_s,
            "capacity": self.capacity,
            "dropped": self.dropped,
            "resets": dict(self.resets),
            "samples": [
                {
                    "wall_ns": s[self.WALL],
                    "hlc_ns": s[self.HLC],
                    "counters": s[self.COUNTERS] or {},
                    "gauges": s[self.GAUGES] or {},
                    "hist": s[self.HIST] or {},
                    **({"slo": s[self.SLO]} if s[self.SLO] else {}),
                }
                for s in self.samples()
            ],
            "slo": self.slo_status(),
        }


# ---------------------------------------------------------------------------
# cluster merge (coordinator side)
# ---------------------------------------------------------------------------


def merge_history_snapshots(snapshots: list[dict]) -> dict:
    """Merge per-daemon ring snapshots onto one cluster timeline.

    Clock alignment is the trace merge's: each snapshot carries a
    ``(wall_ns, hlc_ns)`` pair captured together at export; the
    difference is that machine's offset from the cluster HLC timeline
    and every sample's wall stamp is shifted by it (``t_ns``). Samples
    are tagged with their machine and sorted; derived series (rates,
    windowed percentiles, SLO burn) are computed over the aligned tail.
    """
    samples: list[dict] = []
    resets: dict[str, int] = {}
    dropped = 0
    machines: list[str] = []
    slo: dict[str, dict] = {}
    interval_s = None
    for snap in snapshots:
        if not snap or not snap.get("samples") and not snap.get("slo"):
            if snap:
                interval_s = interval_s or snap.get("interval_s")
            continue
        machine = str(snap.get("machine_id", ""))
        if machine not in machines:
            machines.append(machine)
        offset = int(snap.get("hlc_ns", 0)) - int(snap.get("wall_ns", 0))
        if interval_s is None:
            interval_s = snap.get("interval_s")
        dropped += snap.get("dropped", 0)
        for key, c in snap.get("resets", {}).items():
            resets[key] = resets.get(key, 0) + c
        # Each node lives on exactly one machine: SLO status unions.
        slo.update(snap.get("slo", {}))
        for s in snap.get("samples", []):
            samples.append({
                "t_ns": int(s.get("wall_ns", 0)) + offset,
                "machine": machine,
                "counters": s.get("counters", {}),
                "gauges": s.get("gauges", {}),
                "hist": s.get("hist", {}),
                **({"slo": s["slo"]} if s.get("slo") else {}),
            })
    samples.sort(key=lambda s: s["t_ns"])
    out = {
        "interval_s": interval_s or DEFAULT_INTERVAL_S,
        "machines": machines,
        "samples": samples,
        "resets": resets,
        "dropped": dropped,
        "rates": derive_rates(samples),
        "percentiles": derive_percentiles(samples),
        "util": derive_util(samples),
    }
    if slo:
        out["slo"] = slo
    return out


_UTIL_GAUGES = ("mfu", "device_busy_fraction", "hbm_used_bytes",
                "hbm_limit_bytes", "hbm_peak_bytes",
                "kv_int8", "kv_pool_bytes", "kv_quant_err")


def derive_util(samples: list[dict]) -> dict:
    """Latest device-utilization gauges per serving node — the explicit
    UTIL panel of ``dora-tpu top --json``. ``{node: {mfu: …, …}}``;
    nodes (or whole histories) recorded before round 16 simply don't
    appear — consumers render dashes, never zeros."""
    util: dict[str, dict] = {}
    for s in reversed(samples):
        for key, val in s.get("gauges", {}).items():
            if not key.startswith("srv:"):
                continue
            _, node, name = key.split(":", 2)
            if name in _UTIL_GAUGES:
                util.setdefault(node, {}).setdefault(name, val)
    return util


def _window(samples: list[dict], window_s: float = RATE_WINDOW_S) -> list[dict]:
    if not samples:
        return []
    cutoff = samples[-1]["t_ns"] - int(window_s * 1e9)
    return [s for s in samples if s["t_ns"] >= cutoff]


def _window_span_s(window: list[dict], interval_s: float) -> float:
    """Wall seconds the window covers. Each sample represents one
    interval of deltas, so a single sample still spans ``interval_s``."""
    if not window:
        return 0.0
    span = (window[-1]["t_ns"] - window[0]["t_ns"]) / 1e9
    return span + interval_s if span >= 0 else interval_s


def derive_rates(
    samples: list[dict], window_s: float = RATE_WINDOW_S
) -> dict:
    """Per-second rates over the trailing window, plus the headline
    derived series (total msgs/s, per-node tok/s, respawns/min)."""
    window = _window(samples, window_s)
    if not window:
        return {"per_key": {}, "msgs_per_s": 0.0, "tokens_per_s": {},
                "respawns_per_min": 0.0, "window_s": 0.0}
    # All machines share one cadence; infer it from the densest machine.
    by_machine: dict[str, int] = {}
    for s in window:
        by_machine[s["machine"]] = by_machine.get(s["machine"], 0) + 1
    n_per_machine = max(by_machine.values())
    span = (window[-1]["t_ns"] - window[0]["t_ns"]) / 1e9
    interval = span / (n_per_machine - 1) if n_per_machine > 1 else span or 1.0
    span_s = span + interval if span > 0 else interval
    totals: dict[str, float] = {}
    for s in window:
        for key, d in s["counters"].items():
            totals[key] = totals.get(key, 0) + d
    per_key = {k: round(v / span_s, 3) for k, v in totals.items()}
    msgs = sum(
        v for k, v in totals.items()
        if k.startswith("link:") and k.endswith(":msgs")
    )
    tokens = {
        k[len("srv:"):-len(":decode_tokens")]: round(v / span_s, 2)
        for k, v in totals.items()
        if k.startswith("srv:") and k.endswith(":decode_tokens")
    }
    respawns = sum(v for k, v in totals.items() if k.startswith("respawn:"))
    return {
        "per_key": per_key,
        "msgs_per_s": round(msgs / span_s, 2),
        "tokens_per_s": tokens,
        "respawns_per_min": round(respawns / span_s * 60.0, 3),
        "window_s": round(span_s, 3),
    }


def derive_percentiles(
    samples: list[dict], window_s: float = RATE_WINDOW_S
) -> dict:
    """Windowed percentiles from histogram deltas: what the p50/p99 *was
    over the last minute*, not since dataflow start."""
    window = _window(samples, window_s)
    sums: dict[str, list[int]] = {}
    for s in window:
        for key, d in s["hist"].items():
            counts = sums.setdefault(key, [0] * HISTOGRAM_BUCKETS)
            for i, c in enumerate(d[:HISTOGRAM_BUCKETS]):
                counts[i] += c
    out = {}
    for key, counts in sums.items():
        total = sum(counts)
        if not total:
            continue
        out[key] = {
            "count": total,
            "p50_us": percentile_from_counts(counts, 50),
            "p99_us": percentile_from_counts(counts, 99),
        }
    return out


# ---------------------------------------------------------------------------
# series extraction (sparkline feeds for `top` / `--watch`)
# ---------------------------------------------------------------------------


def counter_series(
    merged: dict, key: str, points: int = 30
) -> list[float]:
    """Trailing per-second rates of one counter key, one value per
    sample interval (cluster-summed per time bucket), oldest first."""
    samples = merged.get("samples", [])
    interval = merged.get("interval_s") or DEFAULT_INTERVAL_S
    if not samples or interval <= 0:
        return []
    # Bucket cluster samples onto the shared cadence so two machines'
    # same-tick samples add instead of interleaving as zigzag.
    buckets: dict[int, float] = {}
    for s in samples:
        b = int(s["t_ns"] / (interval * 1e9))
        buckets[b] = buckets.get(b, 0.0) + s["counters"].get(key, 0)
    ordered = [buckets[b] / interval for b in sorted(buckets)]
    return ordered[-points:]


def gauge_series(merged: dict, key: str, points: int = 30) -> list[float]:
    """Trailing values of one gauge key (cluster max per time bucket —
    gauges live on one machine, max is union), oldest first."""
    samples = merged.get("samples", [])
    interval = merged.get("interval_s") or DEFAULT_INTERVAL_S
    if not samples or interval <= 0:
        return []
    buckets: dict[int, float] = {}
    for s in samples:
        if key not in s["gauges"]:
            continue
        b = int(s["t_ns"] / (interval * 1e9))
        buckets[b] = max(buckets.get(b, 0.0), s["gauges"][key])
    ordered = [buckets[b] for b in sorted(buckets)]
    return ordered[-points:]
