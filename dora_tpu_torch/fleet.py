"""Fleet state plane, the replica side: the port's copy of the node half of
dora_tpu/fleet.py.

Every serving node publishes an ``EngineStateDigest`` on the
``DORA_FLEET_DIGEST_S`` cadence (default 2 s; 0 disables it): a bounded
digest of the radix prefix cache, page and HBM occupancy, the
``fits()``-derived free-stream capacity, the resident adapters and a
fingerprint of the config axes that make two replicas interchangeable. The
daemon keeps the latest per node; aggregation and placement scoring stay
in the JAX package's control plane.
"""

from __future__ import annotations

import hashlib
import os
import time

from dora_tpu_torch.message.common import EngineStateDigest

#: publish cadence in seconds; 0 disables the exporter entirely
DIGEST_INTERVAL_ENV = "DORA_FLEET_DIGEST_S"
DEFAULT_DIGEST_INTERVAL_S = 2.0
#: cached prefixes shipped per digest (bound the wire, not the tree)
TOP_PREFIXES_ENV = "DORA_FLEET_TOP_PREFIXES"
DEFAULT_TOP_PREFIXES = 32


def digest_interval_s() -> float:
    try:
        return float(
            os.environ.get(DIGEST_INTERVAL_ENV, DEFAULT_DIGEST_INTERVAL_S)
        )
    except ValueError:
        return DEFAULT_DIGEST_INTERVAL_S


def digest_top_n() -> int:
    try:
        return int(os.environ.get(TOP_PREFIXES_ENV, DEFAULT_TOP_PREFIXES))
    except ValueError:
        return DEFAULT_TOP_PREFIXES


def weight_bits_from_env() -> int:
    """Weight precision of the serving process, from the same env knobs
    the engine builders read (int4 wins when both are set, matching the
    builder's precedence)."""
    if os.environ.get("DORA_INT4_DECODE", "0") == "1":
        return 4
    if os.environ.get("DORA_INT8_DECODE", "0") == "1":
        return 8
    return 16


def model_id_from_env() -> str:
    ckpt = os.environ.get("DORA_HF_CHECKPOINT", "")
    return os.path.basename(ckpt.rstrip("/")) or "stub"


def config_fingerprint(*, model_id: str, window: int, spec_k: int,
                       kv_dtype: str, weight_bits: int,
                       page_size: int) -> str:
    """Replicas with equal fingerprints are interchangeable targets:
    same model, same decode window K, same speculation width, same KV
    dtype / weight precision, same page geometry. Deterministic across
    processes (blake2b, never the salted builtin hash)."""
    h = hashlib.blake2b(digest_size=8)
    h.update(
        f"{model_id}|K={window}|spec={spec_k}|kv={kv_dtype}"
        f"|w={weight_bits}|ps={page_size}".encode()
    )
    return h.hexdigest()


# ---------------------------------------------------------------------------
# digest construction (replica side)
# ---------------------------------------------------------------------------


def free_stream_capacity(engine, *, prompt_len: int | None = None,
                         max_new: int = 16) -> int:
    """Streams the engine could admit RIGHT NOW, derived from the same
    ``fits``/``pages_needed`` math admission uses: free slots capped by
    the pages a typical stream (one prefill chunk + ``max_new`` decode
    rows) would claim from the free pool plus evictable cached pages.
    Conservative by construction — a router acting on it may under-fill
    a replica, never overload one."""
    free_slots = int(getattr(engine, "free_slots", 0))
    if not hasattr(engine, "free_pages"):
        # slot engine: capacity is slots, gated on the request ever fitting
        return free_slots if engine.fits(prompt_len or 1, max_new) else 0
    if prompt_len is None:
        prompt_len = int(getattr(engine, "chunk", 0)) or 1
    if free_slots == 0 or not engine.fits(prompt_len, max_new):
        return 0
    avail = engine.free_pages
    cache = getattr(engine, "prefix_cache", None)
    if cache is not None:
        avail += cache.evictable_pages()
    per_stream = max(1, engine.pages_needed(prompt_len, max_new))
    return min(free_slots, avail // per_stream)


def build_digest(
    engine,
    *,
    model_id: str | None = None,
    seq: int = 0,
    top_n: int | None = None,
    hbm_used_bytes: int = 0,
    hbm_limit_bytes: int = 0,
    unix_ts: float | None = None,
) -> EngineStateDigest:
    """Snapshot one engine into the wire digest. Pure reads off the
    scheduler thread's own state — bounded work (top-N walk of the
    radix tree), no device sync, so publishing on a cadence stays off
    the decode critical path."""
    if model_id is None:
        model_id = model_id_from_env()
    window = int(getattr(engine, "window", 0) or 0)
    spec_k = int(getattr(engine, "spec_k", 0) or 0)
    kv_dtype = str(getattr(engine, "kv_dtype", "fp") or "fp")
    weight_bits = weight_bits_from_env()
    page_size = int(getattr(engine, "page_size", 0) or 0)
    alloc = getattr(engine, "allocator", None)
    if alloc is not None:
        # page 0 is the allocator's reserved null page — mirror the
        # metrics plane's total_pages convention.
        total_pages = alloc.num_pages - 1
        used_pages = alloc.in_use
        free_pages = alloc.free_pages
    else:
        total_pages = used_pages = free_pages = 0
    cache = getattr(engine, "prefix_cache", None)
    if cache is not None:
        prefixes = [
            [chain, token_len, pages]
            for chain, token_len, pages in cache.digest(
                digest_top_n() if top_n is None else top_n
            )
        ]
        prefix_pages = cache.size
    else:
        prefixes = []
        prefix_pages = 0
    lora = getattr(engine, "lora", None)
    adapters = (
        sorted(lora.streams_by_adapter()) if lora is not None else []
    )
    return EngineStateDigest(
        model_id=model_id,
        fingerprint=config_fingerprint(
            model_id=model_id, window=window, spec_k=spec_k,
            kv_dtype=kv_dtype, weight_bits=weight_bits, page_size=page_size,
        ),
        page_size=page_size,
        window=window,
        spec_k=spec_k,
        kv_dtype=kv_dtype,
        weight_bits=weight_bits,
        max_slots=int(getattr(engine, "max_slots", 0) or 0),
        free_streams=free_stream_capacity(engine),
        used_pages=used_pages,
        free_pages=free_pages,
        total_pages=total_pages,
        prefix_pages=prefix_pages,
        hbm_used_bytes=int(hbm_used_bytes or 0),
        hbm_limit_bytes=int(hbm_limit_bytes or 0),
        adapters=adapters,
        prefixes=prefixes,
        seq=seq,
        unix_ts=time.time() if unix_ts is None else unix_ts,
    )


class DigestPublisher:
    """Owns one serving node's publish cadence: ``tick(now)`` from the
    serving loop's per-second report path; publishes (fire-and-forget)
    when ``DORA_FLEET_DIGEST_S`` elapsed since the last digest. A
    cadence of 0 disables the plane — the A/B bench's "off" arm."""

    def __init__(self, node, engine, *, model_id: str | None = None,
                 interval_s: float | None = None, tracer=None,
                 hbm=None, clock=time.monotonic):
        self.node = node
        self.engine = engine
        self.model_id = model_id
        self.interval_s = (
            digest_interval_s() if interval_s is None else interval_s
        )
        self.tracer = tracer
        #: optional () -> (used_bytes, limit_bytes) from the device monitor
        self.hbm = hbm
        self.clock = clock
        self.seq = 0
        self._last: float | None = None
        self.enabled = (
            self.interval_s > 0 and hasattr(node, "report_engine_state")
        )

    def tick(self, now: float | None = None) -> bool:
        if not self.enabled:
            return False
        now = self.clock() if now is None else now
        if self._last is not None and now - self._last < self.interval_s:
            return False
        self._last = now
        self.seq += 1
        used = limit = 0
        if self.hbm is not None:
            try:
                used, limit = self.hbm()
            except Exception:
                used = limit = 0
        digest = build_digest(
            self.engine, model_id=self.model_id, seq=self.seq,
            hbm_used_bytes=used, hbm_limit_bytes=limit,
        )
        try:
            self.node.report_engine_state(digest)
        except Exception:
            return False  # fleet state is best-effort, like metrics
        if self.tracer is not None:
            self.tracer.instant(
                "fleet_digest", "(engine)",
                f"seq={self.seq} prefixes={len(digest.prefixes)} "
                f"free_streams={digest.free_streams}",
            )
        return True
