"""Deploy-time lint for the alerting plane (``check``): the port's copy of
dora_tpu/analysis/alertcheck.py.

A bad alert rule is worse than no rule: it either never fires (typo'd
selector, percentile over a family that has no histogram) or fires on
noise (for-duration shorter than the sampling cadence evaluates a single
sample). These checks run over the resolved rule set — default pack with
the descriptor's ``alerts:`` block merged in — so a pack override is
linted exactly as the engine will run it, and over the sink environment,
so a webhook sink without an endpoint fails at check time instead of
silently dropping every notification.

Findings are :class:`dora_tpu_torch.analysis.Finding`; stable codes:
``alert-unknown-metric``, ``alert-kind-mismatch``, ``alert-for-below-cadence``,
``alert-percentile-non-histogram``, ``alert-webhook-no-endpoint``.
"""

from __future__ import annotations

import os

from dora_tpu_torch.alerts import (
    ENV_SINK,
    ENV_SINK_WEBHOOK,
    resolved_rules,
    selector_class,
)
from dora_tpu_torch.analysis import Finding
from dora_tpu_torch.metrics_history import history_interval_s

#: metric class each rule kind consumes: (numerator, denominator).
_KIND_CLASSES = {
    "gauge": ("gauge", None),
    "rate": ("counter", None),
    "ratio": ("counter", "counter"),
    "gauge_ratio": ("gauge", "gauge"),
    "percentile": ("hist", None),
}


def check_alerts(descriptor, interval_s: float | None = None) -> list[Finding]:
    """All alerting-plane diagnostics for one parsed descriptor."""
    out: list[Finding] = []
    interval = interval_s if interval_s is not None else history_interval_s()
    for rule in resolved_rules(descriptor.alerts):
        where = f"alerts/{rule.name}"
        if rule.kind != "burn":
            # burn selectors match node names, not series keys — every
            # other kind must name a known flattened metric family.
            for label, selector in (
                ("selector", rule.selector),
                ("denominator", rule.denominator),
            ):
                if selector is None:
                    continue
                cls = selector_class(selector)
                if cls is None:
                    out.append(Finding(
                        "alertcheck", "alert-unknown-metric", "error", where,
                        f"{label} {selector!r} matches no known metric "
                        "family (flatten_snapshot naming: 'srv:<node>:shed', "
                        "'queue:<node>/<input>', 'logerr:<node>', ...)",
                    ))
                    continue
                want = _KIND_CLASSES.get(rule.kind)
                want_cls = want and (want[1] if label == "denominator" else want[0])
                if want_cls and cls != want_cls:
                    code = (
                        "alert-percentile-non-histogram"
                        if rule.kind == "percentile"
                        else "alert-kind-mismatch"
                    )
                    out.append(Finding(
                        "alertcheck", code, "error", where,
                        f"kind {rule.kind!r} needs a {want_cls} {label}, but "
                        f"{selector!r} is a {cls} family",
                    ))
        if 0 < rule.for_s < interval and interval > 0:
            out.append(Finding(
                "alertcheck", "alert-for-below-cadence", "error", where,
                f"for_s={rule.for_s:g} is below the {interval:g}s sampling "
                "cadence — the predicate is evaluated once per sample, so "
                "this is for_s=0 with extra latency; use 0 or >= the cadence",
                detail={"for_s": rule.for_s, "interval_s": interval},
            ))
    out += check_alert_env()
    return out


def check_alert_env(env: dict | None = None) -> list[Finding]:
    """Sink-environment diagnostics (no descriptor needed)."""
    env = os.environ if env is None else env
    out: list[Finding] = []
    sinks = [s.strip() for s in env.get(ENV_SINK, "").split(",") if s.strip()]
    if "webhook" in sinks and not env.get(ENV_SINK_WEBHOOK):
        out.append(Finding(
            "alertcheck", "alert-webhook-no-endpoint", "error", ENV_SINK,
            f"{ENV_SINK} names the webhook sink but {ENV_SINK_WEBHOOK} "
            "is unset — every notification would be dropped",
        ))
    return out
