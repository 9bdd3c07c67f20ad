"""Render the cluster fleet view for ``dora-tpu fleet`` and the `top`
panel.

Pure formatting over two input shapes — the merged fleet view
(``dora_tpu_torch.fleet.merge_fleet_snapshots`` output: full digests plus
``machine``/``age_s``) for the standalone command, and the daemon
metrics snapshot's ``fleet`` gauge block (``dora_tpu_torch.fleet.
fleet_gauges`` output) for the ``top`` panel — so tests feed dicts
directly and the CLI stays a thin query loop. Pre-fleet snapshots (a
history recorded before round 21, a replica that never published)
render dashes, never crash — the SERVING-table backward-compat
convention.
"""

from __future__ import annotations

from dora_tpu_torch.cli.metrics_view import _table


def _age(age_s) -> str:
    if age_s is None:
        return "-"
    s = float(age_s)
    if s < 90:
        return f"{s:.1f}s"
    if s < 5400:
        return f"{s / 60:.0f}m"
    return f"{s / 3600:.1f}h"


def _ratio(used, total) -> str:
    if used is None or not total:
        return "-"
    return f"{used}/{total}"


def fleet_rows(replicas: dict) -> list[list[str]]:
    """Table rows from the merged fleet view's ``replicas`` mapping,
    replica-id order (the same deterministic order score_placement
    falls back to)."""
    rows = []
    for rid in sorted(replicas):
        d = replicas[rid]
        cfg = "-"
        if d.get("fingerprint"):
            cfg = (
                f"K={d.get('window', 0)} spec={d.get('spec_k', 0)} "
                f"kv={d.get('kv_dtype', '?')} w{d.get('weight_bits', '?')}"
            )
        adapters = d.get("adapters") or []
        rows.append([
            rid,
            d.get("machine") or "(local)",
            str(d.get("model_id") or "-"),
            str(d.get("fingerprint") or "-")[:8],
            cfg,
            str(d.get("free_streams", "-")),
            _ratio(d.get("used_pages"), d.get("total_pages")),
            str(d.get("prefix_pages", 0) or 0),
            str(len(d.get("prefixes") or [])),
            ",".join(adapters) if adapters else "-",
            _age(d.get("age_s")),
        ])
    return rows


_HEADER = ["REPLICA", "MACHINE", "MODEL", "FPRINT", "CONFIG",
           "FREE STRM", "PAGES", "PFX PAGES", "PFX N", "ADAPTERS", "AGE"]


def render_fleet(uuid: str, fleet: dict) -> str:
    replicas = fleet.get("replicas") or {}
    machines = fleet.get("machines") or []
    header = (
        f"dora-tpu fleet — dataflow {uuid}"
        f"   {len(replicas)} replica(s)"
    )
    if machines:
        header += (
            f"   machines: {', '.join(m or '(local)' for m in machines)}"
        )
    lines = [header, ""]
    if replicas:
        lines += _table(_HEADER, fleet_rows(replicas))
        # Interchangeability at a glance: replicas sharing a config
        # fingerprint are valid placement alternatives for each other.
        by_fp: dict[str, list[str]] = {}
        for rid in sorted(replicas):
            fp = replicas[rid].get("fingerprint") or ""
            if fp:
                by_fp.setdefault(fp, []).append(rid)
        groups = [ids for ids in by_fp.values() if len(ids) > 1]
        if groups:
            lines += [""] + [
                f"interchangeable: {', '.join(ids)}" for ids in groups
            ]
    else:
        lines += ["(no engine digests published yet)"]
    return "\n".join(lines).rstrip() + "\n"


def render_fleet_panel(fleet_block: dict) -> list[str]:
    """The FLEET section of `dora-tpu top`, from the metrics snapshot's
    per-replica gauge block. Partial entries (pre-fleet history, mixed
    daemon versions) render dashes."""
    if not fleet_block:
        return []
    rows = []
    for nid in sorted(fleet_block):
        f = fleet_block[nid] or {}
        occ = f.get("occupancy")
        rows.append([
            nid,
            str(f.get("free_streams", "-")),
            _ratio(f.get("used_pages"), f.get("total_pages")),
            f"{occ * 100:.0f}%" if occ is not None else "-",
            str(f.get("prefix_pages", "-")),
            _age(f.get("digest_age_s")),
        ])
    return [""] + _table(
        ["FLEET", "FREE STRM", "PAGES", "OCC", "PFX PAGES", "DIGEST AGE"],
        rows,
    )
