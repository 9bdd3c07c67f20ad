"""The one piece of dora_tpu/metrics_history.py the serving node uses: the
burn-window gate of the K autotuner. The history ring itself lives in the
daemon."""

from __future__ import annotations


def burn_window_complete(n_samples: int, window_s: float, interval_s: float) -> bool:
    """Do ``n_samples`` samples cover a full ``window_s`` burn window at
    ``interval_s`` cadence? A burn read over a partial window is noise, so
    the autotuner acts only once this holds."""
    if interval_s <= 0:
        return False
    return n_samples >= max(1, round(window_s / interval_s))
