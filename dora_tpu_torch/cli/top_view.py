"""Render the live full-cluster dashboard for ``dora-tpu top``.

Pure formatting over two inputs — the merged point-in-time snapshot
(``dora_tpu_torch.metrics.merge_snapshots`` output) and the merged history
(``dora_tpu_torch.metrics_history.merge_history_snapshots`` output) — so tests
feed it dicts directly and the CLI stays a thin query loop.

Unlike ``metrics --watch``'s old two-snapshot diffing, every rate and
sparkline here comes from the daemon-side history ring: the first frame
already shows real rates, counter resets were handled server-side, and
the sparklines cover the ring's whole retention window, not just the
frames this CLI process happened to see.
"""

from __future__ import annotations

from dora_tpu_torch.cli.metrics_view import (
    _fmt_bytes,
    _fmt_us,
    _sparkline,
    _table,
)
from dora_tpu_torch.metrics_history import counter_series, gauge_series

#: sparkline cells (ring samples) shown per series
SPARK_POINTS = 40

#: serving-snapshot gauges of the device utilization plane (round 16)
_UTIL_KEYS = ("mfu", "device_busy_fraction", "hbm_used_bytes",
              "hbm_limit_bytes", "hbm_peak_bytes")


def _spark_of(values: list[float], peak: float | None = None) -> str:
    """Values -> sparkline normalized to their own peak (or ``peak``)."""
    if not values:
        return ""
    top = peak if peak else max(values)
    if top <= 0:
        return _sparkline([0.0] * len(values))
    return _sparkline([v / top for v in values])


def render_top(uuid: str, snap: dict, history: dict) -> str:
    rates = history.get("rates") or {}
    per_key = rates.get("per_key", {})
    pctl = history.get("percentiles") or {}
    samples = history.get("samples") or []

    machines = history.get("machines") or []
    header = f"dora-tpu top — dataflow {uuid}"
    if machines:
        header += f"   machines: {', '.join(m or '(local)' for m in machines)}"
    span = (
        (samples[-1]["t_ns"] - samples[0]["t_ns"]) / 1e9 if len(samples) > 1
        else 0.0
    )
    header += (
        f"\n  {len(samples)} samples / {span:.0f}s retained"
        f"   {rates.get('msgs_per_s', 0.0):.1f} msg/s"
    )
    respm = rates.get("respawns_per_min", 0.0)
    if respm:
        header += f"   {respm:.2f} respawns/min"
    dropped = history.get("dropped", 0)
    if dropped:
        header += f"   ring dropped {dropped}"
    resets = history.get("resets") or {}
    if resets:
        header += f"   {sum(resets.values())} counter resets"
    lines = [header, ""]

    # LINKS: totals from the snapshot, rates + sparkline from the ring.
    link_rows = []
    for key in sorted(snap.get("links", {})):
        v = snap["links"][key]
        series = counter_series(history, f"link:{key}:msgs", SPARK_POINTS)
        link_rows.append([
            key,
            str(v.get("msgs", 0)),
            _fmt_bytes(v.get("bytes", 0)),
            f"{per_key.get(f'link:{key}:msgs', 0.0):.1f}",
            f"{_fmt_bytes(per_key.get(f'link:{key}:bytes', 0.0))}/s",
            _spark_of(series),
        ])
    if link_rows:
        lines += _table(
            ["LINK", "MSGS", "BYTES", "MSG/S", "BYTES/S", "TREND"], link_rows
        ) + [""]
    else:
        lines += ["(no routed links yet)", ""]

    # QUEUES: live depth + depth sparkline + windowed latency.
    drops = snap.get("drops", {})
    depths = snap.get("queue_depth", {})
    latency = snap.get("latency_us", {})
    input_rows = []
    for key in sorted(set(drops) | set(depths) | set(latency)):
        h = latency.get(key, {})
        w = pctl.get(f"lat:{key}", {})
        series = gauge_series(history, f"queue:{key}", SPARK_POINTS)
        input_rows.append([
            key,
            str(depths.get(key, 0)),
            _spark_of(series),
            str(drops.get(key, 0)),
            _fmt_us(w.get("p50_us", h.get("p50_us"))),
            _fmt_us(w.get("p99_us", h.get("p99_us"))),
            str(h.get("count", 0)),
        ])
    if input_rows:
        lines += _table(
            ["INPUT", "DEPTH", "TREND", "DROPS", "P50/1m", "P99/1m",
             "DELIVERED"],
            input_rows,
        )

    # SERVING: tok/s from the ring's derived rates, TTFT over the last
    # minute, tok/s + page-occupancy sparklines from the series.
    serving = snap.get("serving", {})
    if serving:
        tokens_per_s = rates.get("tokens_per_s", {})
        serving_rows = []
        for nid in sorted(serving):
            s = serving[nid]
            w = pctl.get(f"srv:{nid}:ttft_us", {})
            ttft = s.get("ttft_us", {})
            tps = tokens_per_s.get(nid)
            series = counter_series(
                history, f"srv:{nid}:decode_tokens", SPARK_POINTS
            )
            serving_rows.append([
                f"{nid} ({s.get('engine', '?')})",
                f"{s.get('slots_active', 0)}/{s.get('slots_total', 0)}",
                (
                    f"{s.get('used_pages', 0)}/{s.get('total_pages', 0)}"
                    if s.get("total_pages") else "-"
                ),
                str(s.get("backlog_depth", 0)),
                str(s.get("decode_tokens", 0)),
                f"{tps:.1f}" if tps is not None else "0.0",
                _spark_of(series),
                _fmt_us(w.get("p50_us", ttft.get("p50_us"))),
                _fmt_us(w.get("p99_us", ttft.get("p99_us"))),
                str(s.get("requests", 0)),
            ])
        lines += [""] + _table(
            ["SERVING", "SLOTS", "PAGES", "BACKLOG", "TOKENS", "TOK/S",
             "TREND", "TTFT P50/1m", "TTFT P99/1m", "REQS"],
            serving_rows,
        )
        for nid in sorted(serving):
            s = serving[nid]
            total = s.get("total_pages") or 0
            if not total:
                continue
            series = gauge_series(
                history, f"srv:{nid}:used_pages", SPARK_POINTS
            )
            lines += [
                f"  pages {nid} [{_spark_of(series, peak=total)}] "
                f"{s.get('used_pages', 0)}/{total} "
                f"peak {s.get('peak_used_pages', 0)}"
            ]

    # UTIL: device utilization plane (round 16) — MFU / busy / HBM
    # gauges from the live snapshot (falling back to the history's
    # derived util block), MFU sparkline from the ring. Nodes without
    # device gauges (pre-round-16 snapshots, monitor off) render
    # dashes or drop out entirely.
    if serving:
        hist_util = history.get("util") or {}
        util_rows = []
        for nid in sorted(serving):
            s = serving[nid]
            u = {**hist_util.get(nid, {}), **{
                k: s[k] for k in _UTIL_KEYS if s.get(k) is not None
            }}
            if not u:
                continue
            mfu = u.get("mfu")
            busy = u.get("device_busy_fraction")
            used, limit = u.get("hbm_used_bytes"), u.get("hbm_limit_bytes")
            peak = u.get("hbm_peak_bytes")
            series = gauge_series(history, f"srv:{nid}:mfu", SPARK_POINTS)
            util_rows.append([
                nid,
                f"{mfu * 100:.1f}%" if mfu is not None else "-",
                f"{busy * 100:.0f}%" if busy is not None else "-",
                (
                    f"{_fmt_bytes(used)}/{_fmt_bytes(limit)}"
                    if used is not None and limit is not None else "-"
                ),
                _fmt_bytes(peak) if peak is not None else "-",
                _spark_of(series, peak=1.0),
            ])
        if util_rows:
            lines += [""] + _table(
                ["UTIL", "MFU", "BUSY", "HBM", "HBM PEAK", "MFU TREND"],
                util_rows,
            )

    # RECOVERY: counters + respawn rate from the ring.
    recovery = snap.get("recovery") or {}
    respawns = recovery.get("respawns") or {}
    replayed = recovery.get("replayed_inputs") or {}
    if respawns or replayed:
        rec_rows = []
        for nid in sorted(set(respawns) | set(replayed)):
            rate = per_key.get(f"respawn:{nid}", 0.0) * 60.0
            rec_rows.append([
                nid,
                str(respawns.get(nid, 0)),
                f"{rate:.2f}",
                str(replayed.get(nid, 0)),
            ])
        lines += [""] + _table(
            ["RECOVERY", "RESPAWNS", "RESPAWNS/MIN", "REPLAYED"], rec_rows
        )

    # SLO burn: the budget fraction consumed per window, plus a
    # violation timeline (one cell per ring sample, ▇ = violating).
    slo = history.get("slo") or snap.get("slo") or {}
    if slo:
        slo_rows = []
        for nid in sorted(slo):
            entry = slo[nid]
            targets = entry.get("targets", {})
            timeline = [
                1.0 if (s.get("slo") and nid in s["slo"]) else 0.0
                for s in samples[-SPARK_POINTS:]
            ]
            last = entry.get("last") or {}
            slo_rows.append([
                nid,
                ",".join(f"{k}={v:g}" for k, v in sorted(targets.items())),
                f"{entry.get('burn_1m', 0.0) * 100:.0f}%",
                f"{entry.get('burn_10m', 0.0) * 100:.0f}%",
                str(entry.get("violations", 0)),
                _sparkline(timeline),
                ",".join(f"{k}={v:g}" for k, v in sorted(last.items()))
                or "-",
            ])
        lines += [""] + _table(
            ["SLO", "TARGETS", "BURN 1M", "BURN 10M", "VIOLATIONS",
             "TIMELINE", "LAST"],
            slo_rows,
        )

    # FLEET: per-replica engine digests (free-stream capacity, page
    # occupancy, prefix-cache footprint, digest age) — the same gauge
    # block `dora-tpu fleet` and prom export. Absent on pre-fleet
    # snapshots, so the panel simply doesn't render there.
    fleet = snap.get("fleet") or {}
    if fleet:
        from dora_tpu_torch.cli.fleet_view import render_fleet_panel

        lines += render_fleet_panel(fleet)

    # ALERTS: active (pending/firing) instances from the merged
    # snapshot's alerts block — evaluated daemon-side by the alert
    # engine, so this panel agrees with `dora-tpu alerts` and prom.
    alerts = snap.get("alerts") or {}
    if alerts.get("rules"):
        from dora_tpu_torch.cli.alerts_view import render_alerts_panel

        lines += render_alerts_panel(alerts)
    return "\n".join(lines).rstrip() + "\n"
