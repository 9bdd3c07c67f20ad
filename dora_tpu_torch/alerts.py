"""Alerting plane: declarative rules evaluated over the metrics history
(the port's copy of dora_tpu/alerts.py: the same rules, states, sinks and
JSON, so a mixed cluster's views read both daemons').

Every KNOWN_ISSUES round so far ended with "watch counter X" addressed
to a human. This module mechanizes that advice: a small rules engine
that evaluates (metric selector, predicate, for-duration, severity)
rules over the retained metrics time series (``metrics_history``) and
drives a pending → firing → resolved state machine per (rule, series
instance), with hysteresis (a separate resolve threshold + clear
duration) and edge-triggered dedup (one notification per incident, a
re-fire after resolve is a new incident).

Evaluation rides the daemon's history sampler tick — the same cadence
that feeds the ring (``DORA_METRICS_HISTORY_S``, default 5 s) — so the
reaction bound is one sampling interval plus the rule's for-duration.
The engine is allocation-disciplined like ``telemetry.FlightRecorder``:
per-instance state lives in small lists mutated in place and the
no-transition steady state allocates only the scratch window sums.

Rule sources: a built-in default pack (:func:`default_rule_pack`) that
encodes the standing "watch this" advice, merged under a descriptor
``alerts:`` block (:class:`AlertsPolicy`) that can disable pack rules
by name, override them (same ``name`` wins), or add new ones.

Transitions surface everywhere the cluster already looks:

* ``alert_pending`` / ``alert_firing`` / ``alert_resolved`` flight
  instants on the daemon's trace track (``dora-tpu trace``),
* the ``dora_alerts`` Prometheus family + firing/resolved counters
  (``prom.py``, via the alerts block in the metrics snapshot),
* the ``QueryAlerts`` control quartet and ``dora-tpu alerts`` CLI,
* pluggable sinks behind ``DORA_ALERT_SINK`` (stderr log, JSONL file,
  webhook POST with a bounded retry budget).
"""

from __future__ import annotations

import json
import logging
import os
import time
from dataclasses import dataclass
from typing import Any, Iterable, Mapping

from dora_tpu_torch.metrics import HISTOGRAM_BUCKETS, percentile_from_counts
from dora_tpu_torch.metrics_history import DEFAULT_INTERVAL_S, MetricsHistoryRing

logger = logging.getLogger(__name__)

SEVERITIES = ("info", "warning", "critical")
OPS = (">", ">=", "<", "<=")
#: Predicate kinds a rule may use (see AlertRule.kind).
KINDS = ("gauge", "rate", "ratio", "gauge_ratio", "percentile", "burn")

#: Instance state codes (AlertEngine._states slot 0).
OK, PENDING, FIRING = 0, 1, 2
_STATE_NAMES = {OK: "ok", PENDING: "pending", FIRING: "firing"}

#: Per-instance state slot layout (lists mutated in place, the
#: FlightRecorder discipline): state code, ns the current condition
#: streak started, ns the current clear streak started, last observed
#: value, completed firing incidents, unix seconds of the last
#: transition.
_STATE, _SINCE, _CLEAR_SINCE, _VALUE, _FIRED, _CHANGED = range(6)


ENV_ENABLED = "DORA_ALERTS"
ENV_SINK = "DORA_ALERT_SINK"
ENV_SINK_FILE = "DORA_ALERT_SINK_FILE"
ENV_SINK_WEBHOOK = "DORA_ALERT_SINK_WEBHOOK"
ENV_WEBHOOK_RETRIES = "DORA_ALERT_WEBHOOK_RETRIES"


def alerts_enabled() -> bool:
    """``DORA_ALERTS`` gate (default on; ``0`` disables evaluation)."""
    return os.environ.get(ENV_ENABLED, "") != "0"


def _cmp(value: float, op: str, threshold: float) -> bool:
    if op == ">":
        return value > threshold
    if op == ">=":
        return value >= threshold
    if op == "<":
        return value < threshold
    return value <= threshold


# ---------------------------------------------------------------------------
# rules + descriptor policy
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AlertRule:
    """One declarative rule.

    ``kind`` selects the predicate input:

    * ``gauge`` — latest value of each series matching ``selector``;
    * ``rate`` — per-second rate of each matching counter over the
      trailing ``window_s``;
    * ``ratio`` — rate(``selector``) / rate(``denominator``) per
      instance (the thrash-detector shape; ``min_rate`` guards the
      denominator so an idle engine never divides noise);
    * ``gauge_ratio`` — latest gauge(``selector``) / gauge
      (``denominator``) per instance (HBM occupancy);
    * ``percentile`` — ``percentile`` over the windowed histogram
      deltas of each matching histogram series;
    * ``burn`` — SLO burn rate per node matching ``selector`` over the
      1 m (``window_s`` <= 60) or 10 m window, gated on the window
      being complete (partial-window burn is noisy, KNOWN_ISSUES
      round 9).

    Selectors are flat series keys (``metrics_history.flatten_snapshot``
    naming: ``srv:<node>:shed``, ``queue:<node>/<input>`` …) with at
    most one ``*`` wildcard; each concrete match is an independent
    alert instance. ``for_s`` is how long the predicate must hold
    before pending becomes firing; ``resolve_threshold``/``clear_s``
    give firing-side hysteresis (default: same threshold, held for
    ``for_s``).
    """

    name: str
    kind: str
    selector: str
    op: str
    threshold: float
    for_s: float = 0.0
    clear_s: float | None = None
    resolve_threshold: float | None = None
    severity: str = "warning"
    window_s: float = 60.0
    percentile: float = 99.0
    denominator: str | None = None
    min_rate: float = 0.0
    labels: tuple[tuple[str, str], ...] = ()

    _KEYS = (
        "name", "kind", "selector", "op", "threshold", "for_s", "clear_s",
        "resolve_threshold", "severity", "window_s", "percentile",
        "denominator", "min_rate", "labels",
    )

    @classmethod
    def parse(cls, value: Any) -> "AlertRule":
        if not isinstance(value, Mapping):
            raise ValueError(f"alert rule must be a mapping, got {value!r}")
        unknown = set(value) - set(cls._KEYS)
        if unknown:
            raise ValueError(f"unknown alert rule keys: {sorted(unknown)}")
        for req in ("name", "kind", "selector", "op", "threshold"):
            if req not in value:
                raise ValueError(f"alert rule missing {req!r}: {dict(value)}")
        name = str(value["name"])
        kind = str(value["kind"])
        if kind not in KINDS:
            raise ValueError(
                f"rule {name!r}: kind {kind!r} not one of {list(KINDS)}"
            )
        op = str(value["op"])
        if op not in OPS:
            raise ValueError(f"rule {name!r}: op {op!r} not one of {list(OPS)}")
        severity = str(value.get("severity", "warning"))
        if severity not in SEVERITIES:
            raise ValueError(
                f"rule {name!r}: severity {severity!r} not one of "
                f"{list(SEVERITIES)}"
            )
        selector = str(value["selector"])
        if selector.count("*") > 1:
            raise ValueError(
                f"rule {name!r}: selector {selector!r} has more than one '*'"
            )
        denominator = value.get("denominator")
        if kind in ("ratio", "gauge_ratio"):
            if not denominator:
                raise ValueError(f"rule {name!r}: kind {kind!r} needs a denominator")
            if str(denominator).count("*") != selector.count("*"):
                raise ValueError(
                    f"rule {name!r}: denominator wildcard shape must match "
                    "the selector"
                )
        elif denominator:
            raise ValueError(
                f"rule {name!r}: denominator only applies to ratio kinds"
            )
        labels_raw = value.get("labels") or {}
        if not isinstance(labels_raw, Mapping):
            raise ValueError(f"rule {name!r}: labels must be a mapping")
        clear_s = value.get("clear_s")
        resolve = value.get("resolve_threshold")
        return cls(
            name=name,
            kind=kind,
            selector=selector,
            op=op,
            threshold=float(value["threshold"]),
            for_s=float(value.get("for_s", 0.0)),
            clear_s=None if clear_s is None else float(clear_s),
            resolve_threshold=None if resolve is None else float(resolve),
            severity=severity,
            window_s=float(value.get("window_s", 60.0)),
            percentile=float(value.get("percentile", 99.0)),
            denominator=None if denominator is None else str(denominator),
            min_rate=float(value.get("min_rate", 0.0)),
            labels=tuple(
                sorted((str(k), str(v)) for k, v in labels_raw.items())
            ),
        )


@dataclass(frozen=True)
class AlertsPolicy:
    """Descriptor ``alerts:`` block: extra rules merged over the default
    pack plus pack rules disabled by name."""

    rules: tuple[AlertRule, ...] = ()
    disable: tuple[str, ...] = ()

    @classmethod
    def parse(cls, value: Any) -> "AlertsPolicy | None":
        if value is None:
            return None
        if not isinstance(value, Mapping):
            raise ValueError(f"alerts block must be a mapping, got {value!r}")
        unknown = set(value) - {"rules", "disable"}
        if unknown:
            raise ValueError(f"unknown alerts keys: {sorted(unknown)}")
        rules = tuple(AlertRule.parse(r) for r in value.get("rules") or ())
        names = [r.name for r in rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate alert rule names: {names}")
        return cls(
            rules=rules,
            disable=tuple(str(n) for n in value.get("disable") or ()),
        )


def default_rule_pack() -> list[AlertRule]:
    """The standing "watch this" advice, mechanized. One rule per
    KNOWN_ISSUES counter a human was told to watch."""
    r = AlertRule.parse
    return [
        # Multi-window SLO burn (round 9): the fast window pages, the
        # slow window warns about sustained budget spend.
        r({"name": "slo-burn-fast", "kind": "burn", "selector": "*",
           "op": ">", "threshold": 0.5, "window_s": 60, "for_s": 10,
           "resolve_threshold": 0.25, "severity": "critical"}),
        r({"name": "slo-burn-slow", "kind": "burn", "selector": "*",
           "op": ">", "threshold": 0.1, "window_s": 600, "for_s": 60,
           "severity": "warning"}),
        # Traffic shaping: sheds and backlog depth spiking.
        r({"name": "shed-spike", "kind": "rate", "selector": "srv:*:shed",
           "op": ">", "threshold": 0.5, "for_s": 10,
           "resolve_threshold": 0.1, "severity": "warning"}),
        r({"name": "backlog-depth", "kind": "gauge",
           "selector": "srv:*:backlog_depth", "op": ">", "threshold": 32,
           "for_s": 10, "resolve_threshold": 16, "severity": "warning"}),
        r({"name": "queue-depth", "kind": "gauge", "selector": "queue:*",
           "op": ">", "threshold": 256, "for_s": 10,
           "resolve_threshold": 128, "severity": "warning"}),
        # Elastic recovery: a stale checkpoint is a wide replay window.
        r({"name": "checkpoint-stale", "kind": "gauge",
           "selector": "srv:*:checkpoint_age_s", "op": ">",
           "threshold": 600, "severity": "warning"}),
        # Trace plane eating its own tail (daemon per-node buffer cap).
        r({"name": "trace-truncated", "kind": "rate",
           "selector": "tracedrop:*", "op": ">", "threshold": 0,
           "severity": "info"}),
        # Device memory ceiling (round 16 gauges).
        r({"name": "hbm-ceiling", "kind": "gauge_ratio",
           "selector": "srv:*:hbm_used_bytes",
           "denominator": "srv:*:hbm_limit_bytes", "op": ">",
           "threshold": 0.92, "for_s": 10, "resolve_threshold": 0.85,
           "severity": "critical"}),
        # Quantized serving: per-page quantization step drifting up
        # (round 18 advice).
        r({"name": "kv-quant-drift", "kind": "gauge",
           "selector": "srv:*:kv_quant_err", "op": ">", "threshold": 0.02,
           "for_s": 30, "severity": "warning"}),
        # Round 19: an undersized LoRA resident budget thrashes —
        # lora_loads growing linearly with REQUESTS (instead of with
        # distinct tenants) means nearly every admission swaps an
        # adapter in. min_rate keeps an idle engine out of the ratio.
        r({"name": "lora-thrash", "kind": "ratio",
           "selector": "srv:*:lora_loads",
           "denominator": "srv:*:requests", "op": ">", "threshold": 0.5,
           "for_s": 30, "min_rate": 0.2, "resolve_threshold": 0.25,
           "severity": "warning"}),
        # Structured log severity (this PR): stderr ERROR lines per
        # second, per node.
        r({"name": "log-errors", "kind": "rate", "selector": "logerr:*",
           "op": ">", "threshold": 1.0, "for_s": 10,
           "resolve_threshold": 0.2, "severity": "warning"}),
        # Fleet plane (round 21): a serving replica whose digest age
        # exceeds 3x the publish cadence is alive (metrics still flow)
        # but its state export is wedged — routers are placing against
        # stale prefix claims. Threshold follows DORA_FLEET_DIGEST_S.
        r({"name": "fleet-digest-stale", "kind": "gauge",
           "selector": "fleet:*:digest_age_s", "op": ">",
           "threshold": _fleet_stale_threshold_s(),
           "for_s": 5, "severity": "warning"}),
    ]


def _fleet_stale_threshold_s() -> float:
    """3x the fleet publish cadence (dora_tpu_torch.fleet.stale_after_s),
    read lazily so the pack follows the env without an import cycle
    (fleet imports nothing from alerts, but keep the seam thin)."""
    from dora_tpu_torch.fleet import stale_after_s

    return stale_after_s()


def resolved_rules(policy: "AlertsPolicy | None") -> list[AlertRule]:
    """Default pack, minus ``disable`` names, with same-name descriptor
    rules overriding and new descriptor rules appended."""
    pack = {rule.name: rule for rule in default_rule_pack()}
    if policy is None:
        return list(pack.values())
    for name in policy.disable:
        pack.pop(name, None)
    for rule in policy.rules:
        pack[rule.name] = rule
    return list(pack.values())


# ---------------------------------------------------------------------------
# selector matching + known-series registry (lint)
# ---------------------------------------------------------------------------


def match_selector(selector: str, key: str) -> str | None:
    """Match a concrete series key against a single-``*`` selector;
    returns the wildcard capture ('' for exact matches, None on miss)."""
    if "*" not in selector:
        return "" if key == selector else None
    prefix, suffix = selector.split("*", 1)
    if (
        len(key) >= len(prefix) + len(suffix)
        and key.startswith(prefix)
        and key.endswith(suffix)
    ):
        return key[len(prefix):len(key) - len(suffix)]
    return None


#: srv:<node>:<name> series shipped by flatten_snapshot, by class —
#: the lint registry (alert-unknown-metric checks selectors here).
SERVING_COUNTER_NAMES = frozenset((
    "decode_tokens", "requests", "rejected", "prefill_chunks",
    "host_dispatches", "compiles", "spec_drafted", "spec_accepted",
    "shed", "preempted", "resumed", "retunes", "prefix_hits",
    "prefix_misses", "prefix_hit_tokens", "prefix_cow_copies",
    "prefix_evictions", "device_compute_ns", "host_dispatch_ns",
    "device_fetch_ns", "dispatched_flops", "useful_flops",
    "lora_loads", "lora_evictions", "adapter_stalls",
))
SERVING_GAUGE_NAMES = frozenset((
    "slots_active", "slots_total", "used_pages", "total_pages",
    "free_pages", "backlog_depth", "autotune_k", "prefix_cached_pages",
    "prefix_shared_pages", "lora_resident", "lora_max_resident",
    "lora_resident_bytes", "mfu", "device_busy_fraction",
    "hbm_used_bytes", "hbm_limit_bytes", "hbm_peak_bytes",
    "kv_pool_bytes", "kv_quant_err", "kv_int8", "checkpoint_age_s",
))

#: fleet:<node>:<name> series (dora_tpu_torch.fleet.fleet_gauges) — all
#: gauges: digest-derived instantaneous state, never cumulative.
FLEET_GAUGE_NAMES = frozenset((
    "digest_age_s", "free_streams", "used_pages", "total_pages",
    "occupancy", "prefix_pages",
))

#: non-serving series prefixes by class.
_COUNTER_PREFIXES = ("drop:", "respawn:", "replay:", "logerr:",
                     "logwarn:", "tracedrop:")
_GAUGE_PREFIXES = ("queue:",)


def selector_class(selector: str) -> str | None:
    """Series class ("counter" | "gauge" | "hist") a selector can match,
    or None when it names no known family — the lint's ground truth.
    Conservative on wildcards: ``srv:*:...`` classifies by the metric
    name segment; a wildcard name segment classifies as unknown."""
    if selector in ("fastroute:hits", "fastroute:fallbacks"):
        return "counter"
    if selector.startswith("link:") and selector.endswith((":msgs", ":bytes")):
        return "counter"
    for prefix in _COUNTER_PREFIXES:
        if selector.startswith(prefix):
            return "counter"
    for prefix in _GAUGE_PREFIXES:
        if selector.startswith(prefix):
            return "gauge"
    if selector.startswith("lat:"):
        return "hist"
    if selector.startswith("srv:"):
        rest = selector[len("srv:"):]
        if ":" not in rest:
            return None
        name = rest.split(":", 1)[1]
        if name == "ttft_us":
            return "hist"
        if name in SERVING_COUNTER_NAMES:
            return "counter"
        if name in SERVING_GAUGE_NAMES:
            return "gauge"
        if name.startswith(("qos_depth:", "adapter_streams:")):
            return "gauge"
    if selector.startswith("fleet:"):
        rest = selector[len("fleet:"):]
        if ":" not in rest:
            return None
        name = rest.split(":", 1)[1]
        if name in FLEET_GAUGE_NAMES:
            return "gauge"
    return None


# ---------------------------------------------------------------------------
# sinks
# ---------------------------------------------------------------------------


class LogSink:
    """Transitions -> the process log (stderr under the default config)."""

    def emit(self, event: dict) -> None:
        level = (
            logging.WARNING
            if event["phase"] == "firing"
            else logging.INFO
        )
        logger.log(
            level,
            "alert %s: %s[%s] value=%s threshold=%s severity=%s",
            event["phase"], event["rule"], event["instance"],
            event["value"], event["threshold"], event["severity"],
        )


class JsonlSink:
    """One JSON object per transition appended to a file
    (``DORA_ALERT_SINK_FILE``)."""

    def __init__(self, path: str):
        self.path = path
        self.errors = 0

    def emit(self, event: dict) -> None:
        try:
            with open(self.path, "a", encoding="utf-8") as f:
                f.write(json.dumps(event, sort_keys=True) + "\n")
        except OSError:
            self.errors += 1


class WebhookSink:
    """POST each transition as JSON to ``DORA_ALERT_SINK_WEBHOOK`` with a
    bounded retry budget (``DORA_ALERT_WEBHOOK_RETRIES`` extra attempts,
    default 2). Failures are counted, never raised — a dead webhook must
    not take the sampler down with it."""

    def __init__(self, url: str, retries: int = 2, timeout_s: float = 1.0):
        self.url = url
        self.retries = max(0, retries)
        self.timeout_s = timeout_s
        self.failures = 0
        self.delivered = 0

    def emit(self, event: dict) -> None:
        import urllib.request

        payload = json.dumps(event, sort_keys=True).encode()
        req = urllib.request.Request(
            self.url, data=payload,
            headers={"Content-Type": "application/json"},
        )
        for _ in range(1 + self.retries):
            try:
                with urllib.request.urlopen(req, timeout=self.timeout_s):
                    self.delivered += 1
                    return
            except Exception:
                continue
        self.failures += 1


def sinks_from_env() -> list:
    """Build the sink chain from ``DORA_ALERT_SINK`` (comma-separated:
    ``log``, ``jsonl``, ``webhook``; empty = no sinks). Misconfigured
    entries are skipped with a log line — `dora-tpu check` flags them
    ahead of time (analysis.alertcheck)."""
    spec = os.environ.get(ENV_SINK, "")
    sinks: list = []
    for name in (s.strip() for s in spec.split(",")):
        if not name:
            continue
        if name == "log":
            sinks.append(LogSink())
        elif name == "jsonl":
            path = os.environ.get(ENV_SINK_FILE, "")
            if path:
                sinks.append(JsonlSink(path))
            else:
                logger.warning("jsonl alert sink without DORA_ALERT_SINK_FILE")
        elif name == "webhook":
            url = os.environ.get(ENV_SINK_WEBHOOK, "")
            if url:
                try:
                    retries = int(
                        os.environ.get(ENV_WEBHOOK_RETRIES, "2")
                    )
                except ValueError:
                    retries = 2
                sinks.append(WebhookSink(url, retries=retries))
            else:
                logger.warning(
                    "webhook alert sink without DORA_ALERT_SINK_WEBHOOK"
                )
        else:
            logger.warning("unknown alert sink %r", name)
    return sinks


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


class AlertEngine:
    """Stateful rule evaluation over history samples.

    One engine per dataflow per daemon (mirroring the history ring);
    :meth:`evaluate_ring` runs on the sampler tick. The same predicate
    core works over a coordinator-merged history
    (:meth:`evaluate_merged`) so cluster-level consumers — the future
    fleet autoscaler — can evaluate the exact rules the daemons run.
    """

    __slots__ = ("rules", "interval_s", "sinks", "_states", "transitions",
                 "firing_total", "resolved_total", "_scratch_rates",
                 "_scratch_gauges", "_scratch_hists")

    def __init__(
        self,
        rules: Iterable[AlertRule],
        interval_s: float | None = None,
        sinks: list | None = None,
    ):
        self.rules = list(rules)
        self.interval_s = (
            interval_s if interval_s is not None else DEFAULT_INTERVAL_S
        )
        self.sinks = sinks if sinks is not None else []
        #: (rule name, instance) -> state slots (mutated in place)
        self._states: dict[tuple[str, str], list] = {}
        self.transitions = {"pending": 0, "firing": 0, "resolved": 0}
        #: per-rule completed transitions (prom counter families)
        self.firing_total: dict[str, int] = {}
        self.resolved_total: dict[str, int] = {}
        # Scratch window sums, cleared (not reallocated) per tick.
        self._scratch_rates: dict[str, float] = {}
        self._scratch_gauges: dict[str, float] = {}
        self._scratch_hists: dict[str, list[int]] = {}

    # -- predicate inputs ---------------------------------------------------

    def _window_view(
        self, samples: list[tuple[int, dict, dict, dict]], window_s: float
    ) -> tuple[dict, dict, dict, float]:
        """(counter sums, latest gauges, hist sums, span_s) over the
        trailing ``window_s`` of normalized samples."""
        rates = self._scratch_rates
        gauges = self._scratch_gauges
        hists = self._scratch_hists
        rates.clear()
        gauges.clear()
        hists.clear()
        if not samples:
            return rates, gauges, hists, 0.0
        cutoff = samples[-1][0] - int(window_s * 1e9)
        first_ns = None
        for t_ns, counters, gs, hs in samples:
            if t_ns < cutoff:
                continue
            if first_ns is None:
                first_ns = t_ns
            for key, d in counters.items():
                rates[key] = rates.get(key, 0.0) + d
            for key, v in gs.items():
                gauges[key] = v
            for key, d in hs.items():
                counts = hists.get(key)
                if counts is None:
                    counts = hists[key] = [0] * HISTOGRAM_BUCKETS
                for i, c in enumerate(d[:HISTOGRAM_BUCKETS]):
                    counts[i] += c
        span = (samples[-1][0] - (first_ns or samples[-1][0])) / 1e9
        # Each sample carries one interval of deltas: a single-sample
        # window still spans one interval (metrics_history._window_span_s).
        span_s = span + self.interval_s if span >= 0 else self.interval_s
        return rates, gauges, hists, span_s

    def _observe(
        self,
        rule: AlertRule,
        samples: list[tuple[int, dict, dict, dict]],
        slo: dict,
    ) -> dict[str, float]:
        """instance -> observed value for one rule (missing series simply
        yield no instance — absent data never fires)."""
        out: dict[str, float] = {}
        if rule.kind == "burn":
            label = "burn_1m" if rule.window_s <= 60 else "burn_10m"
            for node, entry in slo.items():
                if match_selector(rule.selector, node) is None:
                    continue
                if not entry.get(f"{label}_complete"):
                    continue
                out[node] = float(entry.get(label, 0.0))
            return out
        sums, gauges, hists, span_s = self._window_view(
            samples, rule.window_s
        )
        if rule.kind == "gauge":
            for key, v in gauges.items():
                if match_selector(rule.selector, key) is not None:
                    out[key] = float(v)
        elif rule.kind == "rate":
            if span_s > 0:
                for key, total in sums.items():
                    if match_selector(rule.selector, key) is not None:
                        out[key] = total / span_s
        elif rule.kind == "ratio":
            if span_s > 0:
                for key, total in sums.items():
                    capture = match_selector(rule.selector, key)
                    if capture is None:
                        continue
                    den_key = rule.denominator.replace("*", capture, 1)
                    den = sums.get(den_key, 0.0) / span_s
                    if den < max(rule.min_rate, 1e-9):
                        continue
                    out[key] = (total / span_s) / den
        elif rule.kind == "gauge_ratio":
            for key, v in gauges.items():
                capture = match_selector(rule.selector, key)
                if capture is None:
                    continue
                den_key = rule.denominator.replace("*", capture, 1)
                den = gauges.get(den_key)
                if not den:
                    continue
                out[key] = float(v) / float(den)
        elif rule.kind == "percentile":
            for key, counts in hists.items():
                if match_selector(rule.selector, key) is None:
                    continue
                p = percentile_from_counts(counts, rule.percentile)
                if p is not None:
                    out[key] = float(p)
        return out

    # -- state machine ------------------------------------------------------

    def _event(
        self, phase: str, rule: AlertRule, instance: str, value: float,
        now_ns: int,
    ) -> dict:
        self.transitions[phase] += 1
        if phase == "firing":
            self.firing_total[rule.name] = (
                self.firing_total.get(rule.name, 0) + 1
            )
        elif phase == "resolved":
            self.resolved_total[rule.name] = (
                self.resolved_total.get(rule.name, 0) + 1
            )
        event = {
            "phase": phase,
            "rule": rule.name,
            "instance": instance,
            "severity": rule.severity,
            "value": round(value, 6),
            "threshold": rule.threshold,
            "labels": dict(rule.labels),
            "unix_s": round(now_ns / 1e9, 3),
        }
        for sink in self.sinks:
            try:
                sink.emit(event)
            except Exception:
                logger.exception("alert sink failed")
        return event

    def _step_instance(
        self,
        rule: AlertRule,
        instance: str,
        value: float | None,
        now_ns: int,
        events: list[dict],
    ) -> None:
        key = (rule.name, instance)
        st = self._states.get(key)
        if st is None:
            if value is None:
                return
            st = self._states[key] = [OK, 0, 0, 0.0, 0, 0.0]
        if value is not None:
            st[_VALUE] = value
        active = value is not None and _cmp(value, rule.op, rule.threshold)
        if st[_STATE] == OK:
            if active:
                st[_STATE] = PENDING
                st[_SINCE] = now_ns
                st[_CHANGED] = now_ns / 1e9
                events.append(
                    self._event("pending", rule, instance, value, now_ns)
                )
                # A zero for-duration fires on the same tick.
                if now_ns - st[_SINCE] >= rule.for_s * 1e9:
                    st[_STATE] = FIRING
                    events.append(
                        self._event("firing", rule, instance, value, now_ns)
                    )
        elif st[_STATE] == PENDING:
            if not active:
                # Pending cancels silently: it never notified as firing.
                st[_STATE] = OK
                st[_CHANGED] = now_ns / 1e9
            elif now_ns - st[_SINCE] >= rule.for_s * 1e9:
                st[_STATE] = FIRING
                st[_CHANGED] = now_ns / 1e9
                events.append(
                    self._event("firing", rule, instance, value, now_ns)
                )
        else:  # FIRING — hysteresis: clear only below resolve_threshold
            resolve_at = (
                rule.resolve_threshold
                if rule.resolve_threshold is not None
                else rule.threshold
            )
            clear = value is None or not _cmp(value, rule.op, resolve_at)
            if not clear:
                st[_CLEAR_SINCE] = 0
                return
            if st[_CLEAR_SINCE] == 0:
                st[_CLEAR_SINCE] = now_ns
            clear_s = rule.clear_s if rule.clear_s is not None else rule.for_s
            if now_ns - st[_CLEAR_SINCE] >= clear_s * 1e9:
                st[_STATE] = OK
                st[_CLEAR_SINCE] = 0
                st[_FIRED] += 1
                st[_CHANGED] = now_ns / 1e9
                events.append(
                    self._event(
                        "resolved", rule, instance,
                        st[_VALUE] if value is None else value, now_ns,
                    )
                )

    def _evaluate(
        self,
        samples: list[tuple[int, dict, dict, dict]],
        slo: dict,
        now_ns: int,
    ) -> list[dict]:
        events: list[dict] = []
        for rule in self.rules:
            observed = self._observe(rule, samples, slo)
            for instance, value in observed.items():
                self._step_instance(rule, instance, value, now_ns, events)
            # Instances that stopped reporting decay via the clear path.
            for (name, instance), st in self._states.items():
                if name != rule.name or instance in observed:
                    continue
                if st[_STATE] != OK:
                    self._step_instance(rule, instance, None, now_ns, events)
        return events

    def evaluate_ring(
        self, ring: MetricsHistoryRing, now_ns: int | None = None
    ) -> list[dict]:
        """One evaluation tick over a daemon-local ring. Returns the
        transition events (the daemon records them as flight instants)."""
        now_ns = time.time_ns() if now_ns is None else now_ns
        samples = [
            (
                s[MetricsHistoryRing.WALL],
                s[MetricsHistoryRing.COUNTERS] or {},
                s[MetricsHistoryRing.GAUGES] or {},
                s[MetricsHistoryRing.HIST] or {},
            )
            for s in ring.samples()
        ]
        return self._evaluate(samples, ring.slo_status(), now_ns)

    def evaluate_merged(
        self, merged: dict, now_ns: int | None = None
    ) -> list[dict]:
        """One evaluation tick over a coordinator-merged history
        (``metrics_history.merge_history_snapshots`` output) — the
        cluster-level twin of :meth:`evaluate_ring`, on the HLC-aligned
        ``t_ns`` axis."""
        now_ns = time.time_ns() if now_ns is None else now_ns
        samples = [
            (
                s.get("t_ns", 0),
                s.get("counters", {}),
                s.get("gauges", {}),
                s.get("hist", {}),
            )
            for s in merged.get("samples", [])
        ]
        return self._evaluate(samples, merged.get("slo", {}), now_ns)

    # -- export -------------------------------------------------------------

    def status(self) -> dict:
        """JSON-able engine state: per-rule instance states plus the
        transition ledger — the AlertsRequest reply payload and the
        ``alerts`` block of the metrics snapshot."""
        rules: dict[str, dict] = {}
        firing = pending = 0
        by_rule = {r.name: r for r in self.rules}
        for (name, instance), st in sorted(self._states.items()):
            rule = by_rule.get(name)
            entry = rules.setdefault(
                name,
                {
                    "severity": rule.severity if rule else "warning",
                    "labels": dict(rule.labels) if rule else {},
                    "threshold": rule.threshold if rule else None,
                    "instances": {},
                },
            )
            state = _STATE_NAMES[st[_STATE]]
            if st[_STATE] == FIRING:
                firing += 1
            elif st[_STATE] == PENDING:
                pending += 1
            entry["instances"][instance] = {
                "state": state,
                "value": round(st[_VALUE], 6),
                "since_unix": st[_CHANGED],
                "incidents": st[_FIRED] + (1 if st[_STATE] == FIRING else 0),
            }
        return {
            "rules": rules,
            "firing": firing,
            "pending": pending,
            "transitions": dict(self.transitions),
            "firing_total": dict(self.firing_total),
            "resolved_total": dict(self.resolved_total),
        }


def engine_for(
    policy: "AlertsPolicy | None",
    interval_s: float | None = None,
    sinks: list | None = None,
) -> AlertEngine | None:
    """The daemon's constructor: resolved rules + env sinks, or None
    when ``DORA_ALERTS=0``."""
    if not alerts_enabled():
        return None
    return AlertEngine(
        resolved_rules(policy),
        interval_s=interval_s,
        sinks=sinks_from_env() if sinks is None else sinks,
    )


# ---------------------------------------------------------------------------
# cluster merge (coordinator side)
# ---------------------------------------------------------------------------


def merge_alert_status(statuses: list[dict]) -> dict:
    """Union per-machine engine statuses into one cluster view. Alert
    instances are node-scoped series keys, so each lives on exactly one
    machine (the slo-block discipline); counts and ledgers sum."""
    rules: dict[str, dict] = {}
    firing = pending = 0
    transitions = {"pending": 0, "firing": 0, "resolved": 0}
    firing_total: dict[str, int] = {}
    resolved_total: dict[str, int] = {}
    for status in statuses:
        if not status:
            continue
        firing += status.get("firing", 0)
        pending += status.get("pending", 0)
        for phase, n in (status.get("transitions") or {}).items():
            transitions[phase] = transitions.get(phase, 0) + n
        for name, n in (status.get("firing_total") or {}).items():
            firing_total[name] = firing_total.get(name, 0) + n
        for name, n in (status.get("resolved_total") or {}).items():
            resolved_total[name] = resolved_total.get(name, 0) + n
        for name, entry in (status.get("rules") or {}).items():
            merged = rules.setdefault(
                name,
                {
                    "severity": entry.get("severity", "warning"),
                    "labels": dict(entry.get("labels") or {}),
                    "threshold": entry.get("threshold"),
                    "instances": {},
                },
            )
            merged["instances"].update(entry.get("instances") or {})
    return {
        "rules": rules,
        "firing": firing,
        "pending": pending,
        "transitions": transitions,
        "firing_total": firing_total,
        "resolved_total": resolved_total,
    }


def active_alerts(status: dict) -> list[dict]:
    """Flatten a status into displayable rows (firing first, then
    pending, then recently-resolved ok instances), for the CLI table
    and the `top` panel."""
    order = {"firing": 0, "pending": 1, "ok": 2}
    rows: list[dict] = []
    for name, entry in (status.get("rules") or {}).items():
        for instance, inst in (entry.get("instances") or {}).items():
            rows.append({
                "rule": name,
                "instance": instance,
                "severity": entry.get("severity", "warning"),
                "state": inst.get("state", "ok"),
                "value": inst.get("value"),
                "threshold": entry.get("threshold"),
                "since_unix": inst.get("since_unix", 0.0),
                "incidents": inst.get("incidents", 0),
            })
    rows.sort(
        key=lambda r: (order.get(r["state"], 3), r["rule"], r["instance"])
    )
    return rows
