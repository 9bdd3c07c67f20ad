"""Device utilization plane: memory gauges, an analytic FLOPs model, and
on-demand deep profile capture.

Counterpart of dora_tpu/profiling.py, on torch and CUDA. Three tiers,
cheapest first:

1. **Continuous gauges**: :class:`DeviceMonitor` reads the caching
   allocator (``torch.cuda.memory_stats``: bytes allocated now and at
   peak) and the card's total memory (``torch.cuda.mem_get_info``); a CPU
   device, or a CUDA call that fails, gives ``None`` values. With the
   engine's attribution counters (``device_compute_ns`` etc.,
   models/batch_engine) and the analytic per-token FLOPs model below, a
   server derives ``mfu`` and ``device_busy_fraction``.

2. **Window time attribution**: not in this module. The engines split
   each window's (and chunk's) wall time into host dispatch / device
   compute / fetch with a CUDA event recorded after the dispatch and
   synchronized before the device-to-host read (see
   ``PagedBatchEngine.step``), gated on :func:`monitor_enabled` so the
   split costs nothing when off.

3. **Deep capture**: :func:`start_capture` / :func:`stop_capture` run
   ``torch.profiler`` and write its Chrome trace into the capture
   directory. A profiler that cannot start, or writes nothing, still
   leaves an artifact (a synthetic marker file), so a caller always gets
   a path.

The FLOPs model is analytic (config arithmetic, no device introspection):
it is hand-checkable in tests and the same on the CPU and on the card.

MFU counts EMITTED tokens (useful work): a speculative window that drafts
``K x (spec_k+1)`` positions but keeps 3 contributes 3 tokens of useful
FLOPs while the device time covers the whole window; the gap between the
two is the rejected tail.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import sys
import threading
import time

import torch


def monitor_enabled() -> bool:
    """``DORA_DEVICE_MONITOR`` gate for the utilization plane (gauges and
    attribution timing). Default on; ``0`` strips the hooks."""
    return os.environ.get("DORA_DEVICE_MONITOR", "1") not in ("0", "false", "")


# ---------------------------------------------------------------------------
# analytic FLOPs model
# ---------------------------------------------------------------------------


def flops_per_token(
    *,
    dim: int,
    layers: int,
    heads: int,
    kv_heads: int,
    ffn: int,
    vocab: int,
) -> int:
    """Forward FLOPs to process ONE token through a Qwen2-shaped
    transformer (matmul 2·m·n·k arithmetic only; norms, rope and softmax
    are O(dim) at this granularity, and attention's context-length term is
    left out so the number is a constant of the config).

    Per layer: q and o projections (``2·dim·dim`` each), k and v
    projections (``2·dim·kv_heads·head_dim`` each), and the SwiGLU FFN's
    three matmuls (``2·dim·ffn`` each). Plus one lm_head (``2·dim·vocab``).
    """
    head_dim = dim // heads
    per_layer = (
        2 * (2 * dim * dim)                   # q + o projections
        + 2 * (2 * dim * kv_heads * head_dim)  # k + v projections
        + 3 * (2 * dim * ffn)                  # SwiGLU: gate, up, down
    )
    return layers * per_layer + 2 * dim * vocab


def flops_per_token_config(cfg) -> int:
    """:func:`flops_per_token` from a model config object (anything with
    ``dim/layers/heads/kv_heads/ffn/vocab`` attributes, e.g.
    ``Qwen2Config``)."""
    return flops_per_token(
        dim=cfg.dim, layers=cfg.layers, heads=cfg.heads,
        kv_heads=cfg.kv_heads, ffn=cfg.ffn, vocab=cfg.vocab,
    )


def window_flops(*, flops_per_token: int, active: int, k: int,
                 spec_k: int = 0) -> int:
    """Device FLOPs one decode window dispatches: every active stream runs
    K ticks, each forwarding ``spec_k + 1`` positions (1 with speculation
    off). Frozen rows still execute (the window masks their writes, not
    their compute), so this is dispatched work; useful work is emitted ×
    flops_per_token."""
    return active * k * (spec_k + 1) * flops_per_token


#: Peak dense FLOP/s by lower-case device-name substring (bf16, the
#: serving dtype). 989e12 is NVIDIA's H100 SXM data sheet figure for dense
#: bf16 (no sparsity) at the 700 W limit, not a measurement; the SXM part
#: names itself "NVIDIA H100 80GB HBM3". Override with
#: ``DORA_DEVICE_PEAK_FLOPS`` for exact math.
_PEAK_FLOPS_BY_NAME = (
    ("h100 80gb hbm3", 989e12),
    ("h100 sxm", 989e12),
)


def detect_peak_flops(device=None) -> float:
    """Peak FLOP/s for MFU's denominator. ``DORA_DEVICE_PEAK_FLOPS`` wins;
    else the name table on ``torch.cuda.get_device_name`` of ``device``
    (default the current card); else 0.0 (MFU then renders as a dash,
    never a made-up number): a CPU device, no card, or an unknown card."""
    raw = os.environ.get("DORA_DEVICE_PEAK_FLOPS", "")
    if raw:
        try:
            return float(raw)
        except ValueError:
            pass
    dev = torch.device(device) if device is not None else torch.device("cuda")
    if dev.type != "cuda" or not torch.cuda.is_available():
        return 0.0
    try:
        name = torch.cuda.get_device_name(dev).lower()
    except (RuntimeError, AssertionError):
        return 0.0
    for needle, peak in _PEAK_FLOPS_BY_NAME:
        if needle in name:
            return peak
    return 0.0


#: Peak HBM bytes/s by lower-case device-name substring: NVIDIA's H100 SXM
#: data sheet figure (3.35 TB/s), not a measurement.
_PEAK_HBM_BY_NAME = (
    ("h100 80gb hbm3", 3.35e12),
    ("h100 sxm", 3.35e12),
)


def detect_peak_hbm_bytes(device=None) -> float:
    """Peak memory bytes/s for MBU's denominator: the name table on
    ``torch.cuda.get_device_name`` of ``device`` (default the current
    card); 0.0 for a CPU device, no card or an unknown card."""
    dev = torch.device(device) if device is not None else torch.device("cuda")
    if dev.type != "cuda" or not torch.cuda.is_available():
        return 0.0
    name = torch.cuda.get_device_name(dev).lower()
    return next((peak for needle, peak in _PEAK_HBM_BY_NAME if needle in name), 0.0)


# ---------------------------------------------------------------------------
# tier 1: continuous device gauges
# ---------------------------------------------------------------------------


class DeviceMonitor:
    """Reads allocator stats off one device at the report cadence.

    ``memory()`` maps ``torch.cuda.memory_stats`` onto the three memory
    gauges (bytes allocated now, the card's total, the allocator's peak);
    a CPU device, or a CUDA call that fails, degrades to ``None`` values,
    never an exception on the report path."""

    __slots__ = ("device",)

    def __init__(self, device=None):
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        self.device = torch.device(device)

    def memory(self) -> dict:
        """``{"used": int|None, "limit": int|None, "peak": int|None}``."""
        out = {"used": None, "limit": None, "peak": None}
        if self.device.type != "cuda":
            return out
        try:
            stats = torch.cuda.memory_stats(self.device)
            _free, total = torch.cuda.mem_get_info(self.device)
        except (RuntimeError, AssertionError):
            return out
        out["used"] = stats.get("allocated_bytes.all.current")
        out["limit"] = total
        out["peak"] = stats.get("allocated_bytes.all.peak")
        return out

    def peak_flops(self) -> float:
        return detect_peak_flops(self.device)


# ---------------------------------------------------------------------------
# tier 3: on-demand deep capture (torch.profiler)
# ---------------------------------------------------------------------------

#: capture directory -> its running profiler. The profiler is process-wide
#: (one at a time), as jax.profiler's trace is.
_CAPTURES: dict[str, torch.profiler.profile] = {}
#: capture directory -> the experimental options its profiler runs with
_OPTIONS: dict[str, list[str]] = {}


def profile_dir() -> str:
    """``DORA_PROFILE_DIR`` (capture artifact root; default under /tmp)."""
    return os.environ.get("DORA_PROFILE_DIR", "") or "/tmp/dora-tpu-profiles"


def _experimental_config(all_threads: bool):
    """Kineto's experimental config for a capture: with ``all_threads`` the
    host ops of every thread are recorded (the profiler's state is otherwise
    the starting thread's own) and, where this torch has it, ``trace_only``
    skips building Python event objects at stop (the capture is only ever
    exported). With the options it was given; None where this torch has
    neither option."""
    if not all_threads:
        return None, []
    from torch._C._profiler import _ExperimentalConfig

    for kw in ({"profile_all_threads": True, "trace_only": True},
               {"profile_all_threads": True}):
        try:
            return _ExperimentalConfig(**kw), sorted(kw)
        except TypeError:
            continue
    return None, []


def start_capture(out_dir: str, all_threads: bool = False) -> str | None:
    """Start a ``torch.profiler`` trace (CPU activity, and CUDA where a card
    is present) for ``out_dir``; with ``all_threads``, the host ops of every
    thread (a :class:`Capture` starts it on a thread of its own). Returns an
    error string when the profiler cannot start (the caller then gets a
    synthetic artifact at stop time), else None."""
    os.makedirs(out_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    config, options = _experimental_config(all_threads)
    if all_threads and config is None:
        return "this torch cannot profile every thread (profile_all_threads)"
    _OPTIONS[out_dir] = options
    # a new profiler each capture, with acc_events off: its stop only
    # disables Kineto, and no Python event is built unless asked for
    prof = torch.profiler.profile(activities=activities, experimental_config=config)
    try:
        prof.start()
    except RuntimeError as exc:  # another profiler is running
        return f"{type(exc).__name__}: {exc}"
    _CAPTURES[out_dir] = prof
    return None


def stop_capture(out_dir: str, start_error: str | None = None,
                 timings: dict | None = None) -> str:
    """Stop the capture and return the artifact path (always a real path):
    ``out_dir`` holding the Chrome trace ``trace.json``, or, where the
    profiler never started, failed to stop or wrote nothing, a synthetic
    JSON marker whose ``reason`` says why. ``timings``, where given, gets
    the seconds of the stop (``stop_s``) and of the export (``export_s``)."""
    error = start_error
    if error is None:
        prof = _CAPTURES.pop(out_dir, None)
        if prof is None:
            error = f"no capture was started for {out_dir}"
        else:
            try:
                t = time.perf_counter()
                prof.stop()
                t_stop = time.perf_counter()
                prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
                if timings is not None:
                    timings.update(stop_s=t_stop - t, export_s=time.perf_counter() - t_stop)
            except RuntimeError as exc:
                error = f"{type(exc).__name__}: {exc}"
    os.makedirs(out_dir, exist_ok=True)
    if error is not None or not _has_capture_files(out_dir):
        marker = os.path.join(out_dir, "profile_synthetic.json")
        with open(marker, "w") as f:
            json.dump(
                {
                    "synthetic": True,
                    "reason": error or "profiler produced no artifact",
                    "unix_time": time.time(),
                },
                f,
            )
        return marker
    return out_dir


def _has_capture_files(out_dir: str) -> bool:
    for _root, _dirs, files in os.walk(out_dir):
        if set(files) - {KINETO_LOG}:
            return True
    return False


#: the file beside a :class:`Capture`'s trace that holds its step timings
CAPTURE_TIMINGS = "capture.json"

#: the file in a capture's directory that Kineto's own stderr lines go to
KINETO_LOG = "kineto.log"

#: a line of Kineto's: the registration error a profiler started off the
#: thread that imported torch prints, and its glog-style lines
#: ("USDT:2026-10-18 23:16:54 15952:15960 SyncActivityProfilerHandler.cpp:52] ...")
_KINETO_LINE = re.compile(rb"^(ERROR: External init callback must run in same thread"
                          rb"|[A-Z]+:\d{4}-\d\d-\d\d \d\d:\d\d:\d\d \d+:\d+ \w+\.cpp:\d+\])")

_stderr_lock = threading.Lock()


@contextlib.contextmanager
def kineto_lines_aside(path: str):
    """While the block runs, the process's stderr (fd 2) passes through a
    pipe: Kineto's lines (:data:`_KINETO_LINE`) go to ``path``, every other
    line to stderr as before. Kineto writes them from C++ straight to fd 2
    while a capture starts and stops, where a node's daemon would count them
    as the node's error lines."""
    with _stderr_lock:
        sys.stderr.flush()
        saved = os.dup(2)
        read_fd, write_fd = os.pipe()
        os.dup2(write_fd, 2)
        os.close(write_fd)

        def pump() -> None:
            with os.fdopen(read_fd, "rb") as pipe, open(path, "ab") as aside:
                for line in pipe:
                    if _KINETO_LINE.match(line):
                        aside.write(line)
                    else:
                        os.write(saved, line)

        thread = threading.Thread(target=pump, name="dora-kineto-lines", daemon=True)
        thread.start()
        try:
            yield
        finally:
            sys.stderr.flush()
            os.dup2(saved, 2)  # closes the pipe's last write end: the pump ends
            thread.join(timeout=5)
            os.close(saved)


class Capture:
    """One capture on a thread of its own, so that the profiler's start
    (Kineto's and CUPTI's set-up, seconds on its first use in a process),
    stop and export do not run on the caller's loop. Kineto's own stderr
    lines of the start and the stop go to :data:`KINETO_LOG` in the
    capture's directory (:func:`kineto_lines_aside`). Host ops are recorded
    on every thread. ``started`` once the profiler runs (or failed to
    start), ``stop()`` asks it to end, ``done`` once the artifact is
    written; ``artifact`` is then :func:`stop_capture`'s path and
    ``timings`` the seconds each step took, when the profiler ran (unix
    seconds) and its options (also written beside the trace, as
    :data:`CAPTURE_TIMINGS`)."""

    def __init__(self, out_dir: str):
        import threading

        self.out_dir = out_dir
        self.artifact: str | None = None
        self.timings: dict[str, float] = {}
        self.started = threading.Event()
        self.done = threading.Event()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="dora-profile", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        t = time.perf_counter()
        error = None
        os.makedirs(self.out_dir, exist_ok=True)
        kineto_log = os.path.join(self.out_dir, KINETO_LOG)
        try:
            with kineto_lines_aside(kineto_log):
                error = start_capture(self.out_dir, all_threads=True)
        except Exception as exc:  # noqa: BLE001 (the marker says why)
            error = f"{type(exc).__name__}: {exc}"
        self.timings["start_s"] = time.perf_counter() - t
        self.timings["started_unix"] = time.time()
        self.timings["options"] = _OPTIONS.pop(self.out_dir, [])
        self.started.set()
        self._stop.wait()
        self.timings["stopped_unix"] = time.time()
        try:
            with kineto_lines_aside(kineto_log):
                self.artifact = stop_capture(self.out_dir, error, self.timings)
        except Exception as exc:  # noqa: BLE001
            self.artifact = stop_capture(self.out_dir, f"{type(exc).__name__}: {exc}")
        if self.artifact == self.out_dir:
            with open(os.path.join(self.out_dir, CAPTURE_TIMINGS), "w") as f:
                json.dump(self.timings, f)
        self.done.set()

    def stop(self) -> None:
        self._stop.set()

    def wait(self) -> str:
        """Stop, wait for the artifact and return it."""
        self.stop()
        self.done.wait()
        return self.artifact
