"""Trace plane: cluster-wide timeline assembly and Chrome-trace export (the
port's copy of dora_tpu/tracing.py; ``xla_compile`` instants come from JAX
nodes of a mixed cluster).

The raw material is the flight-recorder rings (telemetry.FlightRecorder):
every process records per-message span events — ``t_send`` (node publish),
``t_route`` (daemon route, decoded or fastroute wire path), ``t_deliver``
(daemon -> receiver queue delivery), ``t_recv`` (event-stream receive) —
each slot carrying both ``monotonic_ns`` and the HLC wall clock. Nodes
stream ring growth to their daemon (node_to_daemon.ReportTrace); the
coordinator fans ``TraceRequest`` out to every machine and merges the
per-machine snapshots here.

Clock alignment: monotonic clocks have per-process epochs, so cross-process
ordering uses the wall stamps. Each daemon snapshot carries a
``(wall_ns, hlc_ns)`` pair captured back to back; the HLC physical
component advances to the maximum clock observed anywhere in the cluster
(clock.py), so ``hlc_ns - wall_ns`` is that machine's offset from the
cluster's shared timeline and adding it aligns every machine's wall stamps
onto one axis.

Export is the Chrome trace event format (the ``traceEvents`` JSON that
Perfetto and chrome://tracing load): one ``pid`` per (machine, process)
track, ``ph:"X"`` complete spans for the per-message records (linked by
the W3C trace id in ``args``), ``ph:"i"`` instants for drops, coalesce
flushes, and fastroute fallbacks.
"""

from __future__ import annotations

from typing import Any

from dora_tpu_torch.telemetry import trace_id_of

# FlightRecorder slot indices (see telemetry.FlightRecorder docstring).
MONO, WALL, KIND, A, B, C = range(6)

#: Trace-plane span kinds -> Chrome-trace span name prefix. ``b`` holds
#: the serialized trace context (t_deliver has none — the daemon doesn't
#: decode metadata on the wire path at delivery time), ``c`` the span
#: duration in ns.
SPAN_KINDS = {
    "t_send": "send",
    "t_route": "route",
    "t_deliver": "deliver",
    "t_recv": "recv",
}

#: Serving-engine request-lifecycle span kinds (telemetry.ServingTracer
#: + models/batch_engine) -> span name prefix. Same slot discipline as
#: SPAN_KINDS (``b`` = per-request trace context, ``c`` = dur ns) but
#: exported on the per-process ENGINE track (tid 1) in cat "serving":
#: queued(backlog wait) → admitted(page grant) → prefill_chunk[i] →
#: decode_window[j] → finish(reason).
SERVING_SPAN_KINDS = {
    "s_queued": "queued",
    "s_admitted": "admitted",
    "s_prefill_chunk": "prefill_chunk",
    "s_decode_window": "decode_window",
    "s_finish": "finish",
    # Elastic recovery: checkpoint write / restore-on-respawn, and the
    # two halves of a drain-and-migrate handoff. migrate_out/migrate_in
    # share the request's trace context, so a migrated stream shows ONE
    # contiguous trace id across both engines' tracks.
    "s_checkpoint": "checkpoint",
    "s_restore": "restore",
    "s_migrate_out": "migrate_out",
    "s_migrate_in": "migrate_in",
    # Traffic shaping: a lower-class stream evicted by page preemption
    # (its grant freed for a higher-class request) and its later
    # re-admission (recompute-on-resume). Both carry the stream's trace
    # context, so a preempted request shows one contiguous chain:
    # … decode_window → preempt → queued → resume → prefill_chunk …
    "s_preempt": "preempt",
    "s_resume": "resume",
    # Shared-prefix cache: admission mapped cached KV pages into the new
    # stream's block table (prefill starts at the divergence point).
    # Emitted just before s_admitted, with the same trace context.
    "s_prefix_hit": "prefix_hit",
    # Device-time attribution (dora_tpu_torch.profiling): each fused window /
    # final prefill chunk splits its wall time into host-dispatch →
    # device-compute → device-fetch child spans, emitted per boundary
    # (keyed "window"/"chunk", no request context — one dispatch serves
    # every stream). Retires the round-4 tunnel-vs-compute guesswork:
    # the drift is now measured, not inferred.
    "s_dev_dispatch": "dev_dispatch",
    "s_dev_compute": "dev_compute",
    "s_dev_fetch": "dev_fetch",
}

#: Hot-path flight events surfaced as instants (everything else recorded
#: in the ring also exports as an instant, generically named).
INSTANT_NAMES = {
    "drop_oldest": "drop oldest",
    "coalesce_flush": "coalesce flush",
    "fastroute_fallback": "fastroute fallback",
    "s_reject": "admission reject",
    "s_page_wait": "page wait",
    "xla_compile": "xla compile",
    "trace_truncated": "trace truncated",
    "node_respawn": "node respawn",
    "replay_inputs": "replay inputs",
    "daemon_reconnect": "daemon reconnect",
    "slo_violation": "SLO violation",
    "s_shed": "load shed",
    "k_retune": "window retune",
    "alert_pending": "alert pending",
    "alert_firing": "alert firing",
    "alert_resolved": "alert resolved",
    "fleet_digest": "fleet digest",
}

#: Instants that belong on the engine track and may carry a request
#: trace context in ``b`` (linked into the lifecycle chain by args).
_ENGINE_INSTANTS = {"s_reject", "s_page_wait", "xla_compile", "s_shed",
                    "k_retune"}

#: Chrome-trace tid of the serving-engine track within a process (tid 0
#: is the message plane).
ENGINE_TID = 1

_VALID_PH = {"X", "i", "M"}
_VALID_SCOPES = {"g", "p", "t"}
_VALID_SPAN_CATS = {"message", "serving"}


def merge_trace_snapshots(snapshots: list[dict | None]) -> dict:
    """Merge per-machine daemon snapshots onto one clock-aligned timeline.

    Each snapshot is ``Daemon.trace_snapshot`` output::

        {"machine": str, "wall_ns": int, "hlc_ns": int,
         "processes": {process_name: [[mono, wall, kind, a, b, c], ...]},
         "dropped_events": {process_name: int}}   # optional

    Returns ``{"processes": [{"machine", "process", "events",
    "dropped_events"}, ...]}`` with every event's wall stamp shifted by
    that machine's ``hlc_ns - wall_ns`` offset onto the cluster HLC
    timeline. ``dropped_events`` (events the daemon's per-node buffer
    cap trimmed before this snapshot; ring-level drops ride along as
    ``trace_truncated`` events) is carried per process so the export
    can mark truncated tracks.
    """
    processes: list[dict] = []
    for snap in snapshots:
        if not snap or not snap.get("processes"):
            continue
        offset = int(snap.get("hlc_ns", 0)) - int(snap.get("wall_ns", 0))
        machine = str(snap.get("machine", "?"))
        dropped = snap.get("dropped_events") or {}
        for process, events in sorted(snap["processes"].items()):
            aligned = []
            for e in events:
                if len(e) < 6 or not e[KIND]:
                    continue  # torn/foreign slot shipped by an old node
                e = list(e)
                e[WALL] = int(e[WALL]) + offset
                aligned.append(e)
            aligned.sort(key=lambda e: e[WALL])
            processes.append(
                {
                    "machine": machine,
                    "process": process,
                    "events": aligned,
                    "dropped_events": int(dropped.get(process, 0)),
                }
            )
    processes.sort(key=lambda p: (p["machine"], p["process"]))
    return {"processes": processes}


def _span_args(ctx) -> dict:
    args: dict[str, Any] = {}
    if ctx:
        args["ctx"] = str(ctx)
        trace_id = trace_id_of(str(ctx))
        if trace_id:
            args["trace_id"] = trace_id
    return args


def to_chrome_trace(merged: dict) -> dict:
    """Chrome trace event JSON (Perfetto-loadable) from a merged trace.

    One pid per (machine, process) with an ``M`` process_name record; a
    ``ph:"X"`` complete span per message-plane record whose ``ts`` is the
    span start (wall stamp is taken at record time = span end, so start =
    wall - dur); ``ph:"i"`` instants for everything else. Serving-engine
    lifecycle records (SERVING_SPAN_KINDS + engine instants) land on a
    separate ENGINE track (tid 1, named via a thread_name meta) inside
    the same process pid, cat "serving", so Perfetto shows the request
    chain under the process that served it. A process whose events were
    truncated (daemon buffer cap, ``dropped_events`` from the merge)
    opens with a ``trace truncated`` instant. Timestamps are
    microseconds (floats), rebased to the earliest event so Perfetto's
    axis starts near zero.
    """
    events: list[dict] = []
    processes = merged.get("processes", [])
    base_ns = min(
        (e[WALL] for p in processes for e in p["events"]), default=0
    )
    for pid, proc in enumerate(processes, start=1):
        machine = proc["machine"]
        track = f"{machine}/{proc['process']}" if machine else proc["process"]
        events.append(
            {
                "name": "process_name",
                "ph": "M",
                "pid": pid,
                "tid": 0,
                "args": {"name": track},
            }
        )
        if any(
            e[KIND] in SERVING_SPAN_KINDS or e[KIND] in _ENGINE_INSTANTS
            for e in proc["events"]
        ):
            events.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": pid,
                    "tid": ENGINE_TID,
                    "args": {"name": "engine"},
                }
            )
        dropped = int(proc.get("dropped_events", 0) or 0)
        if dropped > 0:
            first_us = (
                (proc["events"][0][WALL] - base_ns) / 1000.0
                if proc["events"]
                else 0.0
            )
            events.append(
                {
                    "name": f"trace truncated ({dropped} events lost)",
                    "ph": "i",
                    "ts": max(0.0, first_us),
                    "pid": pid,
                    "tid": 0,
                    "s": "p",
                    "cat": "flight",
                }
            )
        for e in proc["events"]:
            kind = e[KIND]
            wall_us = (e[WALL] - base_ns) / 1000.0
            if kind in SPAN_KINDS or kind in SERVING_SPAN_KINDS:
                serving = kind in SERVING_SPAN_KINDS
                name = (SERVING_SPAN_KINDS if serving else SPAN_KINDS)[kind]
                dur_us = max(0, int(e[C] or 0)) / 1000.0
                events.append(
                    {
                        "name": f"{name} {e[A]}",
                        "ph": "X",
                        "ts": max(0.0, wall_us - dur_us),
                        "dur": dur_us,
                        "pid": pid,
                        "tid": ENGINE_TID if serving else 0,
                        "cat": "serving" if serving else "message",
                        "args": _span_args(e[B]),
                    }
                )
            else:
                name = INSTANT_NAMES.get(kind, kind)
                if kind in _ENGINE_INSTANTS:
                    # Engine instants carry the request context in b:
                    # link them into the lifecycle chain, not the label.
                    extra = str(e[A]) if e[A] is not None else ""
                    ev = {
                        "name": f"{name} {extra}".rstrip(),
                        "ph": "i",
                        "ts": max(0.0, wall_us),
                        "pid": pid,
                        "tid": ENGINE_TID,
                        "s": "p",
                        "cat": "serving",
                    }
                    args = _span_args(e[B])
                    if args:
                        ev["args"] = args
                    events.append(ev)
                    continue
                extra = " ".join(str(x) for x in (e[A], e[B]) if x is not None)
                events.append(
                    {
                        "name": f"{name} {extra}".rstrip(),
                        "ph": "i",
                        "ts": max(0.0, wall_us),
                        "pid": pid,
                        "tid": 0,
                        "s": "p",
                        "cat": "flight",
                    }
                )
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def validate_chrome_trace(trace: Any) -> list[str]:
    """Schema self-check for the exporter: every field Perfetto relies on
    is present and well-typed. Returns a list of problems (empty = OK) —
    wired into tier-1 and ``dora-tpu trace --check`` so a malformed field
    fails the suite, not the user's Perfetto session."""
    errors: list[str] = []
    if not isinstance(trace, dict):
        return ["trace is not an object"]
    events = trace.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            errors.append(f"{where}: not an object")
            continue
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            errors.append(f"{where}: name missing or not a string")
        ph = ev.get("ph")
        if ph not in _VALID_PH:
            errors.append(f"{where}: ph {ph!r} not one of {sorted(_VALID_PH)}")
            continue
        for key in ("pid", "tid"):
            if not isinstance(ev.get(key), int) or isinstance(ev.get(key), bool):
                errors.append(f"{where}: {key} missing or not an int")
        if ph == "M":
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or isinstance(ts, bool) or ts < 0:
            errors.append(f"{where}: ts missing, non-numeric, or negative")
        if ph == "X":
            dur = ev.get("dur")
            if (
                not isinstance(dur, (int, float))
                or isinstance(dur, bool)
                or dur < 0
            ):
                errors.append(f"{where}: dur missing, non-numeric, or negative")
            cat = ev.get("cat")
            if cat not in _VALID_SPAN_CATS:
                errors.append(
                    f"{where}: span cat {cat!r} not one of "
                    f"{sorted(_VALID_SPAN_CATS)}"
                )
            elif cat == "serving":
                # Engine lifecycle spans: engine track, known taxonomy.
                if ev.get("tid") != ENGINE_TID:
                    errors.append(
                        f"{where}: serving span on tid {ev.get('tid')!r}, "
                        f"expected engine tid {ENGINE_TID}"
                    )
                prefix = str(ev.get("name", "")).split(" ", 1)[0]
                if prefix not in SERVING_SPAN_KINDS.values():
                    errors.append(
                        f"{where}: serving span name {ev.get('name')!r} "
                        "outside the lifecycle taxonomy"
                    )
        if ph == "i" and ev.get("s") not in _VALID_SCOPES:
            errors.append(f"{where}: instant scope s {ev.get('s')!r} invalid")
    return errors


def _sample_snapshots() -> list[dict]:
    """Two synthetic machine snapshots with deliberate clock skew — the
    offline input for :func:`self_check`. Machine B also hosts a
    serving process with a full request-lifecycle chain (one request
    context), an engine instant, a ring ``trace_truncated`` event, and
    a daemon-side ``dropped_events`` count, so the self-check covers
    the engine track end to end."""
    ctx = "traceparent:00-000102030405060708090a0b0c0d0e0f-0001020304050607-01;"
    base = 1_700_000_000_000_000_000
    # Machine A's wall clock lags the cluster HLC by 5 ms.
    a = {
        "machine": "A",
        "wall_ns": base,
        "hlc_ns": base + 5_000_000,
        "processes": {
            "(daemon)": [
                [10, base + 1_200_000, "t_route", "sender/data", ctx, 150_000],
                [11, base + 1_500_000, "t_deliver", "receiver/in", None, 400_000],
                [12, base + 1_600_000, "drop_oldest", "receiver/in", 3, None],
                # Alert engine transitions land on the daemon track
                # (dora_tpu_torch.alerts via Daemon.sample_history).
                [13, base + 1_700_000, "alert_pending",
                 "queue-depth:receiver/in", "value=300 threshold=256", None],
                [14, base + 1_800_000, "alert_firing",
                 "queue-depth:receiver/in", "value=310 threshold=256", None],
            ],
            "sender": [
                [20, base + 1_000_000, "t_send", "data", ctx, 90_000],
                [21, base + 1_050_000, "coalesce_flush", 4, 4096, None],
            ],
        },
    }
    # Machine B's wall clock runs 2 ms ahead of the cluster HLC. The
    # serving chain shares the message chain's trace id (the tracer
    # derives the request context from the delivered message).
    rctx = "traceparent:00-000102030405060708090a0b0c0d0e0f-1111020304050607-01;"
    b = {
        "machine": "B",
        "wall_ns": base + 2_000_000,
        "hlc_ns": base,
        "processes": {
            # Raw wall base+8.5ms = cluster base+6.5ms — after the sender's
            # aligned base+6ms even though A's raw stamps lag B's.
            "receiver": [
                [30, base + 8_500_000, "t_recv", "in", ctx, 0],
                [31, base + 8_600_000, "fastroute_fallback", "decode", None, None],
            ],
            "llm": [
                [40, base + 8_700_000, "trace_truncated", 17, None, None],
                [41, base + 8_900_000, "s_queued", "req-1", rctx, 100_000],
                [52, base + 8_990_000, "s_prefix_hit", "req-1 tokens=16/24 pages=2", rctx, 0],
                [42, base + 9_000_000, "s_admitted", "req-1 pages=2 shared=2", rctx, 20_000],
                [43, base + 9_300_000, "s_prefill_chunk", "req-1 base=0", rctx, 200_000],
                [53, base + 9_500_000, "s_dev_dispatch", "window", rctx, 30_000],
                [54, base + 9_700_000, "s_dev_compute", "window", rctx, 180_000],
                [55, base + 9_750_000, "s_dev_fetch", "window", rctx, 40_000],
                [44, base + 9_800_000, "s_decode_window", "req-1 k=8 n=5", rctx, 400_000],
                [45, base + 9_850_000, "xla_compile", "window", None, 3_000_000],
                [48, base + 9_860_000, "s_preempt", "req-1 pages=2", rctx, 0],
                [49, base + 9_880_000, "s_resume", "req-1 emitted=5", rctx, 0],
                [46, base + 9_900_000, "s_finish", "req-1 stop", rctx, 0],
                [47, base + 9_950_000, "s_reject", "req-2 length", None, None],
                [50, base + 9_960_000, "s_shed", "req-4 queue_wait", None, None],
                [51, base + 9_970_000, "k_retune", "K 8->4 spec=0", None, None],
            ],
        },
        "dropped_events": {"llm": 23},
    }
    return [a, b, None]


def self_check() -> list[str]:
    """Offline end-to-end check of merge + export + schema: build sample
    snapshots (with clock skew), merge, export, validate — plus a few
    semantic assertions the schema validator can't express. Returns
    problems (empty = OK)."""
    merged = merge_trace_snapshots(_sample_snapshots())
    errors = validate_chrome_trace(to_chrome_trace(merged))
    tracks = {(p["machine"], p["process"]) for p in merged["processes"]}
    if len(tracks) != 4:
        errors.append(f"expected 4 process tracks, got {sorted(tracks)}")
    # Clock alignment: B's recv must land after A's send on the merged
    # axis even though B's raw wall clock ran ahead.
    walls = {
        (p["process"], e[KIND]): e[WALL]
        for p in merged["processes"]
        for e in p["events"]
    }
    send = walls.get(("sender", "t_send"))
    recv = walls.get(("receiver", "t_recv"))
    if send is None or recv is None or recv <= send:
        errors.append(f"alignment broken: send={send} recv={recv}")
    trace = to_chrome_trace(merged)
    ids = {
        ev["args"].get("trace_id")
        for ev in trace["traceEvents"]
        if ev["ph"] == "X" and ev.get("args", {}).get("trace_id")
    }
    if len(ids) != 1:
        errors.append(f"expected one linked trace id, got {ids}")
    # Engine track: the request-lifecycle chain must export in order on
    # tid 1 with its thread_name meta, linked by the same trace id as
    # the message chain that carried the request in.
    engine_spans = [
        ev for ev in trace["traceEvents"]
        if ev["ph"] == "X" and ev.get("cat") == "serving"
    ]
    chain = [ev["name"].split(" ", 1)[0] for ev in engine_spans]
    want = ["queued", "prefix_hit", "admitted", "prefill_chunk",
            "dev_dispatch", "dev_compute", "dev_fetch",
            "decode_window", "preempt", "resume", "finish"]
    if chain != want:
        errors.append(f"lifecycle chain broken: {chain}")
    if any(ev.get("args", {}).get("trace_id") not in ids for ev in engine_spans):
        errors.append("serving spans not linked to the message trace id")
    metas = {
        (ev["pid"], ev["tid"]): ev["args"]["name"]
        for ev in trace["traceEvents"]
        if ev["ph"] == "M" and ev["name"] == "thread_name"
    }
    if "engine" not in metas.values():
        errors.append("engine thread_name meta missing")
    truncated = [
        ev["name"] for ev in trace["traceEvents"]
        if ev["ph"] == "i" and ev["name"].startswith("trace truncated")
    ]
    # One from the ring-shipped event, one from the daemon-cap count.
    if len(truncated) != 2:
        errors.append(f"expected 2 trace-truncated instants, got {truncated}")
    return errors
