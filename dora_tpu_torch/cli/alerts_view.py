"""Render alert status for ``dora-tpu alerts`` and the `top` panel.

Pure formatting over one input — the merged alert status
(``dora_tpu_torch.alerts.merge_alert_status`` / ``AlertEngine.status`` shape)
— so tests feed it dicts directly and the CLI stays a thin query loop.
"""

from __future__ import annotations

import time

from dora_tpu_torch.alerts import active_alerts
from dora_tpu_torch.cli.metrics_view import _table

_STATE_MARKS = {"firing": "!!", "pending": " ~", "ok": "  "}


def _age(since_unix: float, now: float | None = None) -> str:
    if not since_unix:
        return "-"  # instance observed but never transitioned
    now = time.time() if now is None else now
    s = max(0.0, now - since_unix)
    if s < 90:
        return f"{s:.0f}s"
    if s < 5400:
        return f"{s / 60:.0f}m"
    return f"{s / 3600:.1f}h"


def alert_rows(status: dict, now: float | None = None,
               active_only: bool = False) -> list[list[str]]:
    """Table rows (firing first) from a merged status."""
    rows = []
    for r in active_alerts(status):
        if active_only and r["state"] == "ok":
            continue
        value = r["value"]
        threshold = r["threshold"]
        rows.append([
            f"{_STATE_MARKS.get(r['state'], '  ')} {r['rule']}",
            r["instance"],
            r["state"],
            r["severity"],
            f"{value:g}" if value is not None else "-",
            f"{threshold:g}" if threshold is not None else "-",
            _age(r["since_unix"], now),
            str(r["incidents"]),
        ])
    return rows


_HEADER = ["ALERT", "INSTANCE", "STATE", "SEV", "VALUE", "THRESHOLD",
           "FOR", "INCIDENTS"]


def render_alerts(uuid: str, status: dict, now: float | None = None) -> str:
    firing = status.get("firing", 0)
    pending = status.get("pending", 0)
    transitions = status.get("transitions") or {}
    header = (
        f"dora-tpu alerts — dataflow {uuid}"
        f"   {firing} firing / {pending} pending"
        f"   (lifetime: {transitions.get('firing', 0)} fired, "
        f"{transitions.get('resolved', 0)} resolved)"
    )
    lines = [header, ""]
    rows = alert_rows(status, now)
    if rows:
        lines += _table(_HEADER, rows)
    else:
        lines += ["(no alert rules evaluated yet)"]
    return "\n".join(lines).rstrip() + "\n"


def render_alerts_panel(status: dict, now: float | None = None) -> list[str]:
    """The ALERTS section of `dora-tpu top`: active instances only, no
    header line (the dashboard provides its own framing)."""
    rows = alert_rows(status, now, active_only=True)
    if not rows:
        return []
    return [""] + _table(_HEADER, rows)
