"""Render an aggregated metrics snapshot (dora_tpu_torch.metrics) as a
top-style text table for ``dora-tpu metrics [--watch]``.

Pure formatting — no I/O, no control-plane types — so tests can feed it
snapshots directly and the CLI stays a thin loop.
"""

from __future__ import annotations


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024
    return f"{n:.1f}TiB"


def _fmt_us(us: float | None) -> str:
    if us is None:
        return "-"
    if us < 1000:
        return f"{us:.0f}µs"
    if us < 1_000_000:
        return f"{us / 1000:.1f}ms"
    return f"{us / 1_000_000:.2f}s"


_SPARK = " ▁▂▃▄▅▆▇█"

#: serving-snapshot keys that mark a node as carrying the round-16
#: device utilization plane (any present -> UTIL table renders)
_UTIL_KEYS = (
    "mfu", "device_busy_fraction", "hbm_used_bytes", "hbm_limit_bytes",
    "hbm_peak_bytes", "device_compute_ns", "host_dispatch_ns",
    "device_fetch_ns", "kv_dtype", "kv_pool_bytes", "kv_quant_err",
)


def _sparkline(fracs: list[float]) -> str:
    """0..1 fractions as block characters (page-occupancy history)."""
    top = len(_SPARK) - 1
    return "".join(
        _SPARK[round(min(max(f, 0.0), 1.0) * top)] for f in fracs
    )


def _rate(cur: int, before: int, dt: float) -> str:
    """Counter delta over ``dt`` seconds. A negative delta means the
    counter reset to zero (node restart / engine restore re-reporting
    from scratch) — the current value IS the progress since the reset,
    so rate that instead (mirrors the history ring's delta decoder;
    the old ``-`` rendering blanked every rate for a full watch tick
    after a respawn)."""
    delta = cur - before
    if delta < 0:
        delta = cur
    return f"{delta / dt:.1f}"


def _table(headers: list[str], rows: list[list[str]]) -> list[str]:
    widths = [len(h) for h in headers]
    for row in rows:
        for i, cell in enumerate(row):
            widths[i] = max(widths[i], len(cell))
    lines = ["  ".join(h.ljust(w) for h, w in zip(headers, widths)).rstrip()]
    for row in rows:
        lines.append(
            "  ".join(c.ljust(w) for c, w in zip(row, widths)).rstrip()
        )
    return lines


def render_metrics(
    uuid: str,
    snap: dict,
    prev: dict | None = None,
    interval: float | None = None,
    history: list[dict] | None = None,
    rates: dict | None = None,
) -> str:
    """One screenful: header (fastroute ratio), per-link throughput table,
    per-input latency/backlog table. ``rates`` (the ``rates`` block of a
    merged QueryMetricsHistory reply) supplies server-side rates from the
    daemon history ring — the preferred watch-mode source: the first tick
    already has them and counter resets were handled in the ring.
    ``prev`` + ``interval`` are the legacy CLI-side fallback (no history
    ring on the daemon): counter deltas over the MEASURED wall time
    between the two snapshots, clamped to >= 1 ms (snapshots come from
    different daemons — a skewed or back-to-back pair must not explode a
    rate or divide by ~0). ``history`` (older snapshots, oldest first)
    draws the page-occupancy sparkline under the SERVING table."""
    fr = snap.get("fastroute", {})
    ratio = fr.get("hit_ratio")
    header = f"dataflow {uuid}"
    if ratio is not None:
        header += (
            f"   fastroute {ratio * 100:.1f}% "
            f"({fr.get('hits', 0)} hits / {fr.get('fallbacks', 0)} fallbacks)"
        )
    reasons = fr.get("fallback_reasons") or {}
    if reasons:
        listed = ", ".join(f"{k}={v}" for k, v in sorted(reasons.items()))
        header += f"\n  fallback reasons: {listed}"
    lines = [header, ""]

    dt = max(interval, 1e-3) if interval is not None else None
    per_key = (rates or {}).get("per_key", {})
    prev_links = (prev or {}).get("links", {})
    link_rows = []
    for key in sorted(snap.get("links", {})):
        v = snap["links"][key]
        row = [key, str(v.get("msgs", 0)), _fmt_bytes(v.get("bytes", 0))]
        if rates is not None:
            row.append(f"{per_key.get(f'link:{key}:msgs', 0.0):.1f}")
            row.append(
                f"{_fmt_bytes(per_key.get(f'link:{key}:bytes', 0.0))}/s"
            )
        elif dt:
            before = prev_links.get(key, {})
            row.append(_rate(v.get("msgs", 0), before.get("msgs", 0), dt))
            bdelta = v.get("bytes", 0) - before.get("bytes", 0)
            if bdelta < 0:  # counter reset: rate the fresh value
                bdelta = v.get("bytes", 0)
            row.append(f"{_fmt_bytes(bdelta / dt)}/s")
        link_rows.append(row)
    headers = ["LINK", "MSGS", "BYTES"]
    if rates is not None or dt:
        headers += ["MSG/S", "BYTES/S"]
    if link_rows:
        lines += _table(headers, link_rows) + [""]
    else:
        lines += ["(no routed links yet)", ""]

    drops = snap.get("drops", {})
    depths = snap.get("queue_depth", {})
    latency = snap.get("latency_us", {})
    input_keys = sorted(set(drops) | set(depths) | set(latency))
    input_rows = []
    for key in input_keys:
        h = latency.get(key, {})
        input_rows.append([
            key,
            str(depths.get(key, 0)),
            str(drops.get(key, 0)),
            _fmt_us(h.get("p50_us")),
            _fmt_us(h.get("p90_us")),
            _fmt_us(h.get("p99_us")),
            str(h.get("count", 0)),
        ])
    if input_rows:
        lines += _table(
            ["INPUT", "DEPTH", "DROPS", "P50", "P90", "P99", "DELIVERED"],
            input_rows,
        )

    serving = snap.get("serving", {})
    if serving:
        prev_serving = (prev or {}).get("serving", {})
        serving_rows = []
        for nid in sorted(serving):
            s = serving[nid]
            ttft = s.get("ttft_us", {})
            gap = s.get("dispatch_gap_us", {})
            fetch = s.get("fetch_us", {})
            toks = s.get("decode_tokens", 0)
            if rates is not None:
                node_tps = (rates.get("tokens_per_s") or {}).get(nid)
                tps = f"{node_tps:.1f}" if node_tps is not None else "0.0"
            elif dt:
                before = prev_serving.get(nid, {})
                tps = _rate(toks, before.get("decode_tokens", 0), dt)
            else:
                tps = "-"
            pages = (
                f"{s.get('used_pages', 0)}/{s.get('total_pages', 0)}"
                if s.get("total_pages")
                else "-"
            )
            tpd = s.get("tokens_per_dispatch")
            # Draft acceptance rate (speculative decoding). Old
            # snapshots predate the field and spec-off engines never
            # draft: both render as a dash, per the PR-5 convention.
            acc = s.get("spec_acceptance")
            serving_rows.append([
                f"{nid} ({s.get('engine', '?')})",
                f"{s.get('slots_active', 0)}/{s.get('slots_total', 0)}",
                pages,
                str(s.get("backlog_depth", 0)),
                str(toks),
                tps,
                f"{tpd:.1f}" if tpd is not None else "-",
                f"{acc * 100:.0f}%" if acc is not None else "-",
                _fmt_us(ttft.get("p50_us")),
                _fmt_us(ttft.get("p99_us")),
                _fmt_us(gap.get("p50_us")),
                _fmt_us(gap.get("p99_us")),
                _fmt_us(fetch.get("p50_us")),
                str(s.get("compiles", 0)),
                str(s.get("requests", 0)),
            ])
        lines += [""] + _table(
            ["SERVING", "SLOTS", "PAGES", "BACKLOG", "TOKENS", "TOK/S",
             "TOK/DISP", "ACC%", "TTFT P50", "TTFT P99", "GAP P50",
             "GAP P99", "FETCH P50", "COMPILES", "REQS"],
            serving_rows,
        )
        # Page-occupancy sparkline: used/total over the watch history
        # (one cell per refresh, newest right), peak + fragmentation
        # alongside — the at-a-glance "is the pool the bottleneck".
        for nid in sorted(serving):
            s = serving[nid]
            total = s.get("total_pages") or 0
            if not total:
                continue
            fracs = []
            for old in (history or []):
                o = (old.get("serving") or {}).get(nid)
                if o and o.get("total_pages"):
                    fracs.append(
                        o.get("used_pages", 0) / o["total_pages"]
                    )
            fracs.append(s.get("used_pages", 0) / total)
            lines += [
                f"  pages {nid} [{_sparkline(fracs[-48:])}] "
                f"{s.get('used_pages', 0)}/{total} "
                f"peak {s.get('peak_used_pages', 0)} "
                f"contig {s.get('largest_contig_free', 0)}"
            ]

    # Traffic-shaping plane: per-class backlog depths plus the shed /
    # preempt / resume / retune counters. Like RECOVERY, the table only
    # appears once the QoS machinery has actually done something (or a
    # class backlog is non-empty) — an unshaped deployment stays clean.
    if serving:
        qos_rows = []
        for nid in sorted(serving):
            s = serving[nid]
            depths = s.get("qos_depth") or {}
            active = (
                s.get("shed") or s.get("preempted") or s.get("resumed")
                or s.get("retunes") or any(depths.values())
            )
            if not active:
                continue
            qos_rows.append([
                nid,
                str(depths.get("interactive", 0)),
                str(depths.get("standard", 0)),
                str(depths.get("batch", 0)),
                str(s.get("shed", 0)),
                str(s.get("preempted", 0)),
                str(s.get("resumed", 0)),
                str(s.get("autotune_k", 0) or "-"),
                str(s.get("retunes", 0)),
            ])
        if qos_rows:
            lines += [""] + _table(
                ["QOS", "Q:INT", "Q:STD", "Q:BATCH", "SHED", "PREEMPT",
                 "RESUMED", "K", "RETUNES"],
                qos_rows,
            )

    # Shared-prefix cache plane: hit rate, cached/shared page footprint,
    # COW boundary copies, evictions. Only appears once the cache has
    # seen traffic — cache-off engines and old snapshots stay clean.
    if serving:
        prefix_rows = []
        for nid in sorted(serving):
            s = serving[nid]
            lookups = s.get("prefix_hits", 0) + s.get("prefix_misses", 0)
            if not lookups and not s.get("prefix_cached_pages"):
                continue
            rate = s.get("prefix_hit_rate")
            prefix_rows.append([
                nid,
                f"{rate * 100:.0f}%" if rate is not None else "-",
                str(s.get("prefix_hits", 0)),
                str(s.get("prefix_misses", 0)),
                str(s.get("prefix_hit_tokens", 0)),
                str(s.get("prefix_cached_pages", 0)),
                str(s.get("prefix_shared_pages", 0)),
                str(s.get("prefix_cow_copies", 0)),
                str(s.get("prefix_evictions", 0)),
            ])
        if prefix_rows:
            lines += [""] + _table(
                ["PREFIX", "HIT%", "HITS", "MISS", "HIT TOK", "CACHED",
                 "SHARED", "COW", "EVICT"],
                prefix_rows,
            )

    # Multi-tenant LoRA plane: resident-adapter pool occupancy, churn
    # (loads/evictions), adapter HBM bytes, and per-tenant live-stream
    # pins. Only appears once an engine actually serves adapters —
    # single-tenant deployments and old snapshots stay clean.
    if serving:
        tenant_rows = []
        for nid in sorted(serving):
            s = serving[nid]
            streams = s.get("adapter_streams") or {}
            if not s.get("lora_max_resident") and not streams:
                continue
            pinned = ", ".join(
                f"{name}:{n}" for name, n in sorted(streams.items())
            )
            tenant_rows.append([
                nid,
                f"{s.get('lora_resident', 0)}"
                f"/{s.get('lora_max_resident', 0)}",
                _fmt_bytes(s.get("lora_resident_bytes", 0)),
                str(s.get("lora_loads", 0)),
                str(s.get("lora_evictions", 0)),
                pinned or "-",
            ])
        if tenant_rows:
            lines += [""] + _table(
                ["TENANT", "RESIDENT", "BYTES", "LOADS", "EVICT",
                 "STREAMS"],
                tenant_rows,
            )

    # Device utilization plane (round 16): MFU / busy fraction / HBM
    # gauges plus the cumulative window-time attribution. The table
    # appears once any node ships device keys; individual unknown
    # gauges (CPU backend exposes no allocator stats, peak FLOPs
    # undetected) and whole pre-round-16 snapshots render dashes — the
    # PR-5 backward-compat contract.
    if serving:
        util_rows = []
        for nid in sorted(serving):
            s = serving[nid]
            if not any(k in s for k in _UTIL_KEYS):
                continue
            mfu = s.get("mfu")
            busy = s.get("device_busy_fraction")
            used, limit = s.get("hbm_used_bytes"), s.get("hbm_limit_bytes")
            peak = s.get("hbm_peak_bytes")
            hbm = (
                f"{_fmt_bytes(used)}/{_fmt_bytes(limit)}"
                if used is not None and limit is not None
                else "-"
            )
            pool = s.get("kv_pool_bytes")
            qerr = s.get("kv_quant_err")
            util_rows.append([
                nid,
                f"{mfu * 100:.1f}%" if mfu is not None else "-",
                f"{busy * 100:.0f}%" if busy is not None else "-",
                hbm,
                _fmt_bytes(peak) if peak is not None else "-",
                f"{s.get('device_compute_ns', 0) / 1e6:.0f}ms",
                f"{s.get('host_dispatch_ns', 0) / 1e6:.0f}ms",
                f"{s.get('device_fetch_ns', 0) / 1e6:.0f}ms",
                s.get("kv_dtype") or "-",
                _fmt_bytes(pool) if pool is not None else "-",
                f"{qerr * 100:.2f}%" if qerr is not None else "-",
            ])
        if util_rows:
            lines += [""] + _table(
                ["UTIL", "MFU", "BUSY", "HBM", "HBM PEAK", "DEV",
                 "DISP", "FETCH", "KV", "KV POOL", "QERR"],
                util_rows,
            )
            # MFU sparkline over the watch history (one cell per
            # refresh, newest right) — the at-a-glance "is the device
            # actually busy".
            for nid in sorted(serving):
                s = serving[nid]
                if s.get("mfu") is None:
                    continue
                fracs = []
                for old in (history or []):
                    o = (old.get("serving") or {}).get(nid)
                    if o and o.get("mfu") is not None:
                        fracs.append(o["mfu"])
                fracs.append(s["mfu"])
                lines += [
                    f"  mfu {nid} [{_sparkline(fracs[-48:])}] "
                    f"{s['mfu'] * 100:.1f}%"
                ]

    # Elastic-recovery plane: daemon-side respawn/replay counters merge
    # with serving-side checkpoint/migration counters by node id. The
    # table only appears once something recovered — steady state stays
    # clean.
    recovery = snap.get("recovery") or {}
    respawns = recovery.get("respawns") or {}
    replayed = recovery.get("replayed_inputs") or {}
    rec_nodes = set(respawns) | set(replayed)
    for nid, s in serving.items():
        if (s.get("checkpoints") or s.get("restored_streams")
                or s.get("migrated_out") or s.get("migrated_in")):
            rec_nodes.add(nid)
    if rec_nodes:
        rec_rows = []
        for nid in sorted(rec_nodes):
            s = serving.get(nid, {})
            age = s.get("checkpoint_age_s")
            rec_rows.append([
                nid,
                str(respawns.get(nid, 0)),
                str(replayed.get(nid, 0)),
                str(s.get("checkpoints", 0)),
                f"{age:.1f}s" if age is not None else "-",
                str(s.get("restored_streams", 0)),
                str(s.get("migrated_out", 0)),
                str(s.get("migrated_in", 0)),
            ])
        lines += [""] + _table(
            ["RECOVERY", "RESPAWNS", "REPLAYED", "CKPTS", "CKPT AGE",
             "RESTORED", "MIG OUT", "MIG IN"],
            rec_rows,
        )
    return "\n".join(lines).rstrip() + "\n"
