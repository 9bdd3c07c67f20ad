"""LLM serving node of the port: a continuous-batching responder for the
OpenAI gateway, run as a dora node by the JAX package's daemon.

Counterpart of dora_tpu/nodehub/llm_server.py. Every ``text`` input that
carries a ``request_id`` is admitted into an engine slot; each engine step
runs one prefill chunk and one K-tick decode window over every live stream,
and token deltas stream back on ``response`` tagged ``{request_id, done,
seq}`` (plus ``finish`` on the last chunk). ``serve()`` is the JAX
``serve()``: the per-class admission queue (``QosConfig``,
``AdmissionQueue``), shedding with a retriable ``overloaded`` chunk,
preemption with recompute-on-resume (``DORA_QOS_PREEMPT=1``), the SLO checks
and K autotuner (``DORA_SLO_*``, ``DORA_AUTOTUNE_*``), on-demand profile
captures, the serving metrics ``dora-tpu metrics`` shows (reported every
second) and the fleet digest (``DORA_FLEET_DIGEST_S``). The metrics'
``compiles`` is the engine's CUDA-graph captures.

``make_engine`` reads the same knobs with the same meaning as the JAX one
(``DORA_PAGED_KV`` (0: the dense batch engine, whose ``DORA_BATCH_SLOTS``
defaults to 4), ``DORA_BATCH_SLOTS``, ``DORA_PAGE_SIZE``,
``DORA_PREFILL_CHUNK``, ``DORA_MULTISTEP_K``, ``DORA_PREFIX_CACHE`` (on by
default here), ``DORA_PREFIX_CACHE_PAGES``, ``DORA_SPEC_K``,
``DORA_SPEC_NGRAM``, ``DORA_KV_INT8``, ``DORA_LORA_DIR`` /
``DORA_LORA_MAX_RESIDENT`` / ``DORA_LORA_RANK``).

Dataflow usage (``--device`` defaults to cuda; ``--device cpu`` runs the
kernels' plain versions)::

    - id: llm
      path: module:dora_tpu_torch.nodehub.llm_server
      args: --device cuda
      inputs: {text: api/text}
      outputs: [response]
      env: {DORA_HF_CHECKPOINT: /path/to/qwen2}

The node needs ``DORA_HF_CHECKPOINT`` (a Qwen2-family safetensors
directory) or ``DORA_STUB_ENGINE=1`` (the weight-free stub engine, tokens
rendered as `` t<id>``). The node's wire needs msgpack and, for Arrow
payloads, pyarrow: ``dora_tpu_torch.node`` imports them when the node runs,
never this module.

Recovery, on the paged engine, as in the JAX node: ``DORA_CHECKPOINT_DIR``
(with ``DORA_CHECKPOINT_EVERY``, default every 8 steps, and
``DORA_CHECKPOINT_PAGES=1`` to save the KV pools too) writes the live
serving state to ``state.json`` atomically, at that cadence, on SIGTERM and
at a clean exit, and restores it when the node starts again: mid-generation
streams resume, and every chunk carries a ``seq`` so consumers drop the
replayed ones. A ``MIGRATE`` event drains every stream (and the parked
backlog) into a handoff file in its ``handoff_dir``; a node with
``DORA_MIGRATE_DIR`` stays up past the end of its inputs and admits the
handoff files that appear there. ``state.json`` and the handoff files are
the JAX node's format; the pools file is the port's own.

Without a dataflow, ``--prompts`` answers a JSON list of token-id lists
through ``submit`` / ``step`` and prints one JSON line per request::

    python -m dora_tpu_torch.nodehub.llm_server --prompts prompts.json
    python -m dora_tpu_torch.nodehub.llm_server --prompts prompts.json \\
        --random-config qwen2_1_5b --max-new 128

Weights come from ``DORA_HF_CHECKPOINT`` (``DORA_MAX_SEQ`` caps the
context), or are seeded random at a named config with ``--random-config``.
With a checkpoint, a stream ends at the tokenizer's end-of-turn token (the
first of :data:`EOS_NAMES` among its added tokens) or at ``--max-new``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import deque


#: end-of-turn tokens a checkpoint's tokenizer may carry, in the order of
#: preference of dora_tpu/nodehub/llm_server.py's main
EOS_NAMES = ("<|im_end|>", "<|endoftext|>", "</s>", "<|eot_id|>")


def eos_token(tok) -> int | None:
    """The id of the first of :data:`EOS_NAMES` among the added tokens of
    ``tok`` (a models/tokenizer.BPETokenizer, or None: no tokenizer)."""
    if tok is None:
        return None
    return next((tok.added[name] for name in EOS_NAMES if name in tok.added), None)


def make_engine(params, cfg, eos=None, device=None, graphs: bool | None = None):
    """The serving engine from the env knobs: paged by default, the dense
    batch engine (``qwen2.make_batch_engine``, ``DORA_BATCH_SLOTS`` slots,
    default 4) with ``DORA_PAGED_KV=0``. On the paged engine the prefix
    cache is on unless ``DORA_PREFIX_CACHE=0``; ``DORA_SPEC_K`` /
    ``DORA_SPEC_NGRAM``, ``DORA_KV_INT8`` and the LoRA knobs
    (``DORA_LORA_DIR``, ``DORA_LORA_MAX_RESIDENT``, ``DORA_LORA_RANK``)
    reach it through ``make_paged_engine``. ``graphs`` reaches either
    factory: None runs the decode windows (or the dense step) as CUDA-graph
    replays on a CUDA device, False eagerly."""
    from dora_tpu_torch.models.hf import qwen2

    paged = os.environ.get("DORA_PAGED_KV", "1") != "0"
    slots = int(os.environ.get("DORA_BATCH_SLOTS", "16" if paged else "4"))
    if not paged:
        return qwen2.make_batch_engine(params, cfg, max_slots=slots, eos=eos,
                                       device=device, graphs=graphs)
    chunk_env = os.environ.get("DORA_PREFILL_CHUNK")
    return qwen2.make_paged_engine(
        params, cfg,
        max_slots=slots,
        eos=eos,
        page_size=int(os.environ.get("DORA_PAGE_SIZE", "16")),
        chunk=int(chunk_env) if chunk_env else None,
        window=int(os.environ.get("DORA_MULTISTEP_K", "8")),
        prefix_cache=os.environ.get("DORA_PREFIX_CACHE", "1") != "0",
        prefix_cache_pages=int(os.environ.get("DORA_PREFIX_CACHE_PAGES", "0")),
        device=device,
        graphs=graphs,
    )


def serve_prompts(engine, prompts, max_new: int, on_token=None, others=None,
                  adapters=None):
    """Serve every prompt to completion on either engine, admitting in
    order: a request the engine cannot admit yet waits at the head of the
    line until slots, pages and its adapter's residency free up. Returns
    {request index: tokens} and per-request time-to-first-token seconds
    (from the start of the run). ``on_token(index, token, done)`` sees every
    emission. Streams already in the engine run on beside them; ``others``
    maps each such request id to the list their tokens are appended to.
    ``adapters`` names each request's LoRA tenant (None = the base model),
    as the JAX server routes a request's ``model`` field; it reaches the
    engine only where one is set (the dense engine takes none). A submit
    that returns a token (the dense engine's synchronous first token) is
    emitted at once, as the JAX server does."""
    adapters = list(adapters) if adapters is not None else [None] * len(prompts)
    if len(adapters) != len(prompts):
        raise ValueError(f"{len(adapters)} adapters for {len(prompts)} prompts")

    def tenant(i):
        return {"adapter": adapters[i]} if adapters[i] else {}

    waiting = deque(range(len(prompts)))
    for i in waiting:
        if not engine.fits(len(prompts[i]), max_new, **tenant(i)):
            raise ValueError(f"request {i} can never fit ({len(prompts[i])}+{max_new}"
                             + (f", adapter {adapters[i]!r}" if adapters[i] else "") + ")")
    out: dict[int, list[int]] = {i: [] for i in range(len(prompts))}
    ttft: dict[int, float] = {}
    t0 = time.perf_counter()

    def emit(rid: str, token: int, done: bool) -> None:
        if others is not None and rid in others:
            others[rid].append(token)
            return
        i = int(rid)
        if not out[i]:
            ttft[i] = time.perf_counter() - t0
        out[i].append(token)
        if on_token is not None:
            on_token(i, token, done)

    while waiting or engine.active:
        while waiting and engine.can_admit(len(prompts[waiting[0]]), max_new,
                                           **tenant(waiting[0])):
            i = waiting.popleft()
            first = engine.submit(str(i), prompts[i], max_new, **tenant(i))
            if first is not None:  # dense engine: the first token is synchronous
                emit(str(i), *first)
        for rid, token, done in engine.step():
            emit(rid, token, done)
    return out, ttft


#: QoS priority classes, highest first. Weights are drain-order scores, not
#: shares: the scheduler admits the class whose HEAD scores highest, aging
#: multiplying a head's weight by ``1 + waited / aging_s``, so a parked
#: ``batch`` head overtakes a fresh ``interactive`` one after
#: ``(8 / 1 - 1) * aging_s`` seconds: batch never starves, and never jumps a
#: live interactive burst.
QOS_CLASSES = ("interactive", "standard", "batch")
QOS_WEIGHTS = {"interactive": 8.0, "standard": 4.0, "batch": 1.0}

#: request ``model`` values that mean the base model (no LoRA adapter); any
#: other name is a tenant, resolved against the engine's adapter catalog
BASE_MODEL_NAMES = ("", "dora-tpu", "base")

class QosConfig:
    """Traffic-shaping knobs, from the descriptor's ``qos:`` block (the
    daemon injects it as ``DORA_QOS_*`` env). Unset bounds keep the
    unshaped behaviour: one FIFO class, never shed, never preempt."""

    __slots__ = ("default_class", "depths", "shed_wait_s", "aging_s", "preempt_on")

    def __init__(self, *, default_class="standard", depths=None, shed_wait_s=None,
                 aging_s=10.0, preempt_on=False):
        if default_class not in QOS_CLASSES:
            raise ValueError(f"unknown QoS class {default_class!r}")
        self.default_class = default_class
        #: per-class parked-entry bound (None = unbounded)
        self.depths: dict[str, int | None] = {c: (depths or {}).get(c) for c in QOS_CLASSES}
        #: queue-wait shed deadline, seconds (None = wait forever)
        self.shed_wait_s = shed_wait_s
        #: aging time constant, seconds (0 / None: no aging)
        self.aging_s = aging_s
        self.preempt_on = preempt_on

    @classmethod
    def from_env(cls) -> "QosConfig":
        def _f(key):
            raw = os.environ.get(key, "")
            try:
                return float(raw) if raw else None
            except ValueError:
                return None

        def _i(key):
            v = _f(key)
            return int(v) if v is not None else None

        default = os.environ.get("DORA_QOS_DEFAULT_CLASS", "standard")
        shed_ms = _f("DORA_QOS_SHED_WAIT_MS")
        aging = _f("DORA_QOS_AGING_S")
        return cls(
            default_class=default if default in QOS_CLASSES else "standard",
            depths={c: _i(f"DORA_QOS_DEPTH_{c.upper()}") for c in QOS_CLASSES},
            shed_wait_s=shed_ms / 1000.0 if shed_ms is not None else None,
            aging_s=aging if aging is not None else 10.0,
            preempt_on=os.environ.get("DORA_QOS_PREEMPT", "") == "1",
        )


class AdmissionQueue:
    """Per-class weighted backlog in front of a serving engine.

    Only ``fits()``-admissible requests enter (the caller rejects the rest
    up front), so every head can start once capacity frees. :meth:`drain`
    must run wherever capacity may have appeared: after a push, after a
    step, and on the idle path.

    Each drain iteration admits the class whose head scores highest
    (QOS_WEIGHTS aged by wait); within a class, FIFO. No cross-class
    bypass: a small ``batch`` request never slips past a blocked
    ``interactive`` head (that is preemption's job).

    ``on_shed(key, reason, waited_s)`` fires when a push overflows its class
    bound or a parked entry outlives its queue-wait deadline (``shed_wait_s``,
    tightened per request by ``deadline_s``). ``preempt(cls)`` is asked when
    the best head cannot start: True after evicting (and re-parking via
    :meth:`requeue`) a lower-class victim makes drain re-score and retry.
    ``on_admit(key, waited_s)`` fires just before a parked request starts;
    ``on_stall(key, reason)`` when a head's block reason changes
    (``engine.admit_blocker``: ``capacity`` or ``adapter_residency``)."""

    def __init__(self, engine, start, on_admit=None, clock=time.monotonic,
                 qos: QosConfig | None = None, on_shed=None, preempt=None, on_stall=None):
        self._engine = engine
        self._start = start
        self._on_admit = on_admit
        self._clock = clock
        self._qos = qos or QosConfig()
        self._on_shed = on_shed
        self._preempt = preempt
        self._on_stall = on_stall
        #: key -> why its head-of-class admission is blocked, set once per
        #: parking episode
        self._stall_reasons: dict[str, str] = {}
        #: class -> [[key, ids, max_new, t_in, deadline_s, adapter], ...] FIFO
        self._q: dict[str, list[list]] = {c: [] for c in QOS_CLASSES}

    def __len__(self) -> int:
        return sum(len(q) for q in self._q.values())

    def depths(self) -> dict[str, int]:
        """Per-class parked depth (the qos_depth gauges)."""
        return {c: len(q) for c, q in self._q.items()}

    def queued(self, key: str) -> bool:
        return any(entry[0] == key for q in self._q.values() for entry in q)

    def stall_reason(self, key: str) -> str | None:
        """Why ``key``'s parking episode is blocked (valid inside on_admit /
        on_shed)."""
        return self._stall_reasons.get(key)

    def push(self, key: str, ids: list[int], max_new: int, qos: str | None = None,
             deadline_s: float | None = None, adapter: str | None = None) -> bool:
        """Park, then drain. False when shed at the door (class bound)."""
        cls = qos if qos in QOS_CLASSES else self._qos.default_class
        cap = self._qos.depths.get(cls)
        if cap is not None and len(self._q[cls]) >= cap:
            if self._on_shed is not None:
                self._on_shed(key, f"depth:{cls}", 0.0)
            return False
        self._q[cls].append([key, ids, max_new, self._clock(), deadline_s, adapter])
        self.drain()
        return True

    def requeue(self, key: str, ids: list[int], max_new: int, qos: str | None = None,
                adapter: str | None = None) -> None:
        """Park a preempted stream at the FRONT of its class with its wait
        clock reset (a re-aged victim outscoring its preemptor would
        ping-pong the slot). No drain: called from inside the preempt hook."""
        cls = qos if qos in QOS_CLASSES else self._qos.default_class
        self._q[cls].insert(0, [key, ids, max_new, self._clock(), None, adapter])

    def _shed_expired(self) -> None:
        if self._on_shed is None:
            return
        now = self._clock()
        for q in self._q.values():
            kept = []
            for entry in q:
                limit = self._qos.shed_wait_s
                if entry[4] is not None:
                    limit = entry[4] if limit is None else min(limit, entry[4])
                waited = now - entry[3]
                if limit is not None and waited > limit:
                    self._on_shed(entry[0], "queue_wait", waited)
                    self._stall_reasons.pop(entry[0], None)
                else:
                    kept.append(entry)
            q[:] = kept

    def _best(self, now: float) -> str | None:
        best_cls, best_score = None, -1.0
        for cls in QOS_CLASSES:
            q = self._q[cls]
            if not q:
                continue
            score = QOS_WEIGHTS[cls]
            if self._qos.aging_s:
                score *= 1.0 + (now - q[0][3]) / self._qos.aging_s
            if score > best_score:
                best_cls, best_score = cls, score
        return best_cls

    def drain(self) -> None:
        self._shed_expired()
        while True:
            now = self._clock()
            cls = self._best(now)
            if cls is None:
                return
            key, ids, max_new, t_in, _dl, adapter = self._q[cls][0]
            # Only paged engines take an adapter (the front door rejects
            # tenants on the dense engine).
            tenant = {"adapter": adapter} if adapter else {}
            if not self._engine.can_admit(len(ids), max_new, **tenant):
                if self._preempt is not None and self._preempt(cls):
                    continue  # a victim was evicted: re-score and retry
                blocker = getattr(self._engine, "admit_blocker", None)
                reason = (blocker(len(ids), max_new, adapter) if blocker is not None
                          else "capacity") or "capacity"
                if self._stall_reasons.get(key) != reason:
                    self._stall_reasons[key] = reason
                    if self._on_stall is not None:
                        self._on_stall(key, reason)
                return
            self._q[cls].pop(0)
            if self._on_admit is not None:
                self._on_admit(key, now - t_in)
            self._stall_reasons.pop(key, None)
            if adapter:
                self._start(key, ids, max_new, adapter)
            else:
                self._start(key, ids, max_new)

    def pending(self) -> list[tuple[str, list[int], int, str, str | None]]:
        """The parked requests in class-priority order, as checkpoints and
        migration handoffs carry them (the wait start and the deadline are
        this process's and are dropped)."""
        return [(k, list(ids), mn, cls, ad)
                for cls in QOS_CLASSES
                for k, ids, mn, _t, _dl, ad in self._q[cls]]

    def take_all(self) -> list[tuple[str, list[int], int, str, str | None]]:
        """Empty the backlog without starting anything (a migrate-out: the
        parked requests travel with the live streams)."""
        out = self.pending()
        for q in self._q.values():
            q.clear()
        self._stall_reasons.clear()
        return out


def _run_loop(node, engine, backlog, metrics, handle_input, emit, report,
              clock=time.monotonic, on_tick=None, on_step=None, handle_migrate=None,
              handle_profile=None, on_engine_error=None, keep_alive=False,
              fleet_tick=None) -> None:
    """The window-granular serving loop. Each iteration: take a burst of
    pending events, run one engine step (a prefill chunk and a K-tick
    window) and emit its tokens, then ALWAYS drain the backlog (capacity
    appears when a step frees slots or pages, and an idle engine must admit
    parked requests too). ``on_engine_error()`` fails the in-flight
    requests before a step's exception propagates.

    The recovery hooks, which :func:`serve` wires when the env asks for
    them: ``on_tick()`` runs first in each iteration and returns True to
    stop (the SIGTERM checkpoint); ``on_step()`` runs after a step's tokens
    are emitted (the checkpoint cadence: never between a step and its
    emits, where a snapshot would count tokens the wire never saw);
    ``handle_migrate(event)`` drains the live streams on a ``MIGRATE`` at
    this window boundary; ``keep_alive`` parks instead of returning when
    the inputs end (a migration target waits for handoffs until STOP)."""
    last_step_end: float | None = None
    report_last = clock()
    while True:
        if on_tick is not None and on_tick():
            break
        # A burst of events before the next window (the first recv parks
        # when the engine is idle, the rest only poll): one recv per step
        # would queue an arrival burst upstream of the admission plane,
        # where classes, deadlines and preemption cannot see it. The bound
        # keeps a flood from starving the decode loop.
        event = None
        stop = False
        for burst in range(128):
            event = node.recv(timeout=0.0 if engine.active or burst else 0.25)
            if event is None:
                break
            if event["type"] == "STOP":
                stop = True
                break
            if event["type"] == "INPUT":
                handle_input(event)
            elif event["type"] == "MIGRATE" and handle_migrate is not None:
                handle_migrate(event)
            elif event["type"] == "PROFILE" and handle_profile is not None:
                handle_profile(event)
        if stop:
            break
        if event is None and node.stream_ended and engine.active == 0 and len(backlog) == 0:
            if not keep_alive:
                break
            # The inputs are closed but handoffs may still come: do not spin
            # (recv returns at once on a closed stream).
            time.sleep(0.05)
        if engine.active:
            now = clock()
            if last_step_end is not None:
                # Host time between one dispatch's end and the next one's
                # start: the gap the K-window amortizes.
                metrics.dispatch_gap.observe((now - last_step_end) * 1e6)
            try:
                stepped = engine.step()
            except Exception:
                if on_engine_error is not None:
                    on_engine_error()
                raise
            for key, token, done in stepped:
                emit(key, token, done)
            last_step_end = clock()
            if on_step is not None:
                on_step()
        else:
            last_step_end = None  # a gap across idle is queue wait
        backlog.drain()
        now = clock()
        if now - report_last >= 1.0:
            report(now)
            report_last = now
        elif fleet_tick is not None:
            # Digests may run faster than the 1 Hz report (report() ticks
            # the publisher too).
            fleet_tick(now)


def serve(node, engine, metrics, *, encode, decode_one, eos=None, max_new_cap=32,
          tracer=None, clock=time.monotonic) -> None:
    """Serve ``node``'s requests on an already built engine until the input
    stream ends, then close the node: the JAX ``serve()`` on the port's
    engines, for the real node and for a scripted one alike.

    ``node`` gives ``recv(timeout)``, ``stream_ended``, ``send_output(id,
    [text], metadata)``, ``report_serving(snapshot)``, ``report_profile``
    and ``close()`` (``report_engine_state`` turns the fleet digest on).
    ``encode(text)`` turns a request into token ids, ``decode_one(token)`` a
    token into its text. A ``ServingTracer`` (``tracer``, default one) and
    ``metrics`` are attached to the engine, which records its lifecycle
    spans and fetch and grant histograms through them.

    Recovery (engines with ``checkpoint_state``, i.e. the paged one):
    ``DORA_CHECKPOINT_DIR`` restores ``state.json`` at the start, writes it
    every ``DORA_CHECKPOINT_EVERY`` steps (8; 0 = never), on SIGTERM (the
    loop stops at its next tick) and at a clean exit, and drops a replayed
    input whose wire ``request_id`` it already admitted;
    ``DORA_CHECKPOINT_PAGES=1`` saves and restores the KV pools beside it
    (best effort, as in the JAX node). A ``MIGRATE`` event drains the
    streams into its ``handoff_dir``; ``DORA_MIGRATE_DIR`` keeps the loop up
    past the end of the inputs and admits the handoffs found there."""
    from dora_tpu_torch import fleet, profiling, telemetry
    from dora_tpu_torch.metrics import percentile_from_counts
    from dora_tpu_torch.metrics_history import burn_window_complete

    if tracer is None:
        tracer = telemetry.ServingTracer()
    engine.tracer = tracer
    engine.serving_metrics = metrics
    paged = hasattr(engine, "free_pages")
    # The recovery knobs; only an engine with the checkpoint surface (the
    # paged one) uses them.
    can_ckpt = hasattr(engine, "checkpoint_state")
    ckpt_dir = os.environ.get("DORA_CHECKPOINT_DIR") if can_ckpt else None
    ckpt_every = int(os.environ.get("DORA_CHECKPOINT_EVERY", "8") or 0)
    migrate_dir = os.environ.get("DORA_MIGRATE_DIR") if can_ckpt else None

    # SLO targets (the descriptor's slo: block, DORA_SLO_* at spawn): the
    # daemon's history is the authoritative burn source; checking here too
    # puts a violation on this process's engine track.
    def _slo_env(key: str) -> float | None:
        raw = os.environ.get(key, "")
        try:
            return float(raw) if raw else None
        except ValueError:
            return None

    slo_ttft_ms = _slo_env("DORA_SLO_TTFT_P99_MS")
    slo_tok_s = _slo_env("DORA_SLO_TOKENS_PER_S_MIN")
    slo_queue = _slo_env("DORA_SLO_QUEUE_DEPTH_MAX")
    slo_prev: dict = {"t": None, "tokens": 0, "ttft": []}
    qos = QosConfig.from_env()
    # Preemption needs the engine's preempt (the dense engine serves
    # without it).
    can_preempt = qos.preempt_on and hasattr(engine, "preempt")
    #: per-request bookkeeping; req_prompt / req_emitted (token ids) let a
    #: preempted stream resume by re-prefilling prompt + emitted, and are
    #: kept only while preemption is on
    req_class: dict[str, str] = {}
    #: engine key -> LoRA tenant (None = base), carried through requeues
    req_adapter: dict[str, str | None] = {}
    req_prompt: dict[str, list[int]] = {}
    req_emitted: dict[str, list[int]] = {}
    admit_seq: dict[str, int] = {}
    admit_counter = [0]
    preempted_keys: set[str] = set()
    #: engine key -> tokens whose cached prefix is pinned while the victim
    #: waits to resume
    pinned_prefix: dict[str, list[int]] = {}
    #: engine key (req-N, always unique) -> wire request_id: two in-flight
    #: requests with one wire id must not share a slot key
    wire_ids: dict[str, str | None] = {}
    #: engine key -> arrival time, pending its first token (TTFT)
    t_admitted: dict[str, float] = {}
    req_counter = [0]
    #: engine key -> next chunk sequence number; a restored stream replays
    #: chunks with the same (request_id, seq), so consumers drop them
    seqs: dict[str, int] = {}
    #: wire request_ids already admitted (checkpoint mode): the daemon's
    #: replay of an unacknowledged input must not start a restored stream
    #: twice
    seen_rids: dict[str, None] = {}
    #: keys whose backlog wait was attributed to adapter residency: the next
    #: wire chunk carries the tag
    stall_tags: dict[str, str] = {}

    def _forget(key: str) -> None:
        for d in (req_class, req_adapter, req_prompt, req_emitted, admit_seq, stall_tags):
            d.pop(key, None)
        preempted_keys.discard(key)
        pinned = pinned_prefix.pop(key, None)
        if pinned is not None:
            # A parked victim that never resumed releases its pin.
            engine.prefix_unpin(pinned)

    def emit_text(key: str, text: str, done: bool, finish: str | None = None,
                  extra: dict | None = None) -> None:
        meta: dict = {"done": bool(done)}
        if done:
            # "stop" (EOS) or "length" (cap); "rejected" (could never fit)
            # and "overloaded" (shed under load) are retriable signals.
            meta["finish"] = finish or "stop"
        if extra:
            meta.update(extra)
        stalled = stall_tags.pop(key, None)
        if stalled is not None and "stall_reason" not in meta:
            meta["stall_reason"] = stalled
        seq = seqs.get(key, 0)
        meta["seq"] = seq
        if done:
            seqs.pop(key, None)
        else:
            seqs[key] = seq + 1
        rid = wire_ids.get(key)
        if rid is not None:
            meta["request_id"] = rid
        t0 = t_admitted.pop(key, None)
        if t0 is not None:
            # The paged engine runs its window after the chunk that made the
            # first token, inside one step(): subtract the time the token
            # sat host-side (emit_lag_s).
            lag = engine.emit_lag_s.pop(key, 0.0)
            metrics.ttft.observe(max(0.0, clock() - t0 - lag) * 1e6)
        node.send_output("response", [text], meta)
        if done:
            wire_ids.pop(key, None)
            _forget(key)
            tracer.finish(key, finish or "stop")

    def emit(key: str, token: int, done: bool) -> None:
        finish = None
        if done:
            finish = "stop" if (eos is not None and token == eos) else "length"
        metrics.decode_tokens += 1
        if can_preempt and not done and key in req_emitted:
            req_emitted[key].append(token)
        emit_text(key, decode_one(token), done, finish)

    def on_stall(key: str, reason: str) -> None:
        if reason == "adapter_residency":
            metrics.adapter_stalls += 1
            tracer.instant("s_page_wait", key, "adapter_residency")

    def on_admit(key: str, waited_s: float) -> None:
        metrics.backlog_wait.observe(waited_s * 1e6)
        if backlog.stall_reason(key) == "adapter_residency":
            stall_tags[key] = "adapter_residency"
        tracer.span("s_queued", key, dur_ns=int(waited_s * 1e9))

    def start(key: str, ids: list[int], max_new: int, adapter: str | None = None) -> None:
        admit_counter[0] += 1
        admit_seq[key] = admit_counter[0]
        if key in preempted_keys:
            # A preempted stream re-admits: its prefill recomputes prompt +
            # emitted, so what it decodes from here is the unpreempted run's.
            preempted_keys.discard(key)
            metrics.resumed += 1
            tracer.span("s_resume", key, f"recompute={len(ids)}")
        res = engine.submit(key, ids, max_new, **({"adapter": adapter} if adapter else {}))
        pinned = pinned_prefix.pop(key, None)
        if pinned is not None:
            # Unpin after submit: the resume has mapped the shared pages.
            engine.prefix_unpin(pinned)
        if res is not None:  # the dense engine's synchronous first token
            emit(key, *res)

    def on_shed(key: str, reason: str, waited_s: float) -> None:
        # Overload becomes a fast retriable signal, never an unbounded backlog.
        metrics.shed += 1
        t_admitted.pop(key, None)  # a shed stream has no first token
        tracer.instant("s_shed", key, f"{reason} waited={waited_s:.3f}s")
        extra = {"retry_after_ms": int(max(100.0, (qos.shed_wait_s or 1.0) * 1000.0))}
        if backlog.stall_reason(key) == "adapter_residency":
            extra["stall_reason"] = "adapter_residency"
        emit_text(key, "", True, finish="overloaded", extra=extra)

    def try_preempt(cls: str) -> bool:
        """A ``cls`` head is blocked on capacity: evict ONE victim of a
        strictly lower class (lowest class first, then youngest: the
        cheapest recompute) and park it for its resume. The queue re-scores
        after True, so several victims go one grant at a time."""
        rank = QOS_CLASSES.index(cls)
        victim, vkey = None, (-1, -1)
        for s in engine.slots:
            if s is None:
                continue
            k = s.request_id
            r = QOS_CLASSES.index(req_class.get(k, qos.default_class))
            if r <= rank or k not in req_prompt:
                continue  # only strictly lower classes, with resume bookkeeping
            cand = (r, admit_seq.get(k, 0))
            if cand > vkey:
                victim, vkey = k, cand
        if victim is None:
            return False
        meta = engine.preempt(victim)
        if meta is None:
            return False
        remaining = meta["max_new"] - meta["emitted"]
        if remaining <= 0:
            emit_text(victim, "", True, finish="length")  # raced with completion
            return True
        preempted_keys.add(victim)
        resume_ids = list(req_prompt.get(victim, [])) + list(req_emitted.get(victim, []))
        if engine.prefix_pin(resume_ids):
            # The victim's cached prefix survives the wait: its resume
            # re-prefills only the unshared tail.
            pinned_prefix[victim] = resume_ids
        backlog.requeue(victim, resume_ids, remaining, req_class.get(victim),
                        adapter=req_adapter.get(victim))
        return True

    backlog = AdmissionQueue(engine, start, on_admit=on_admit, clock=clock, qos=qos,
                             on_shed=on_shed, preempt=try_preempt if can_preempt else None,
                             on_stall=on_stall)

    def handle_input(event) -> None:
        meta = event.get("metadata") or {}
        rid = meta.get("request_id")
        if ckpt_dir and rid is not None:
            if rid in seen_rids:
                tracer.instant("s_reject", f"req:{rid}", "replay-dup")
                return
            seen_rids[rid] = None
            while len(seen_rids) > 4096:
                seen_rids.pop(next(iter(seen_rids)))
        value = event["value"]
        # An Arrow array (what the gateway sends) or raw bytes.
        text = (value.to_pylist()[0] if hasattr(value, "to_pylist")
                else bytes(value or b"").decode(errors="replace"))
        req_counter[0] += 1
        key = f"req-{req_counter[0]}"
        wire_ids[key] = rid
        metrics.requests += 1
        # Engine spans join the trace of the message that carried the request.
        tracer.begin(key, str(meta.get(telemetry.OTEL_CTX_KEY, "") or ""))
        ids = encode(text) or [0]
        max_new = min(int(meta.get("max_new_tokens", max_new_cap)), max_new_cap)
        cls = meta.get("qos_class") or meta.get("priority")
        if cls not in QOS_CLASSES:
            cls = qos.default_class
        try:
            dl = float(meta.get("deadline_ms", "") or 0) / 1000.0
        except (TypeError, ValueError):
            dl = 0.0
        deadline_s = dl if dl > 0 else None
        req_class[key] = cls
        # The OpenAI ``model`` field: a non-base name is a LoRA tenant of
        # this engine's adapter pool.
        model = str(meta.get("model") or "")
        adapter = model if model not in BASE_MODEL_NAMES else None
        lora_pool = getattr(engine, "lora", None)
        req_adapter[key] = adapter
        tenant = {"adapter": adapter} if adapter else {}
        if max_new <= 0:
            metrics.rejected += 1
            tracer.instant("s_reject", key, "max_new<=0")
            emit_text(key, "", True, finish="length")
        elif adapter is not None and (lora_pool is None or not lora_pool.has(adapter)):
            # Never servable here: a non-retriable reject.
            metrics.rejected += 1
            tracer.instant("s_reject", key, f"unknown model {adapter!r}")
            emit_text(key, "", True, finish="rejected",
                      extra={"reject_reason": "unknown_model", "model": adapter})
        elif not engine.fits(len(ids), max_new, **tenant):
            # Never admissible: the payload says why (its grant against the
            # pool and the block table).
            metrics.rejected += 1
            extra: dict = {"reject_reason": "oversized"}
            if paged:
                extra["pages_needed"] = engine.pages_needed(len(ids), max_new)
                extra["pool_pages"] = engine.allocator.num_pages - 1
                extra["max_seq"] = engine.max_seq
            tracer.instant("s_reject", key, f"oversized len={len(ids)}")
            emit_text(key, "", True, finish="rejected", extra=extra)
        else:
            t_admitted[key] = clock()
            if can_preempt:
                req_prompt[key] = list(ids)
                req_emitted[key] = []
            if not backlog.push(key, ids, max_new, cls, deadline_s, adapter=adapter):
                return  # shed at the door (class depth bound)
            if backlog.queued(key):
                tracer.instant("s_page_wait", key,
                               f"qos={cls} backlog={len(backlog)} "
                               f"free_pages={getattr(engine, 'free_pages', 0)}")

    def check_slo(now: float) -> None:
        """The DORA_SLO_* targets over the deltas since the previous report:
        TTFT p99 from this tick's histogram delta; tokens/s only while the
        engine serves."""
        if slo_ttft_ms is None and slo_tok_s is None and slo_queue is None:
            return
        prev_t, slo_prev["t"] = slo_prev["t"], now
        toks = metrics.decode_tokens
        counts = list(metrics.ttft.counts)
        if prev_t is None or now <= prev_t:
            slo_prev["tokens"] = toks
            slo_prev["ttft"] = counts
            return
        dt = now - prev_t
        if slo_ttft_ms is not None:
            delta = [c - p for c, p in zip(counts, slo_prev["ttft"])]
            if any(d > 0 for d in delta):
                p99 = percentile_from_counts(delta, 99)
                if p99 is not None and p99 > slo_ttft_ms * 1000.0:
                    tracer.instant("slo_violation", "(engine)",
                                   f"ttft_p99_ms observed={p99 / 1000.0:.1f} "
                                   f"target={slo_ttft_ms:g}")
        if slo_tok_s is not None:
            rate = (toks - slo_prev["tokens"]) / dt
            if (engine.active or toks > slo_prev["tokens"]) and rate < slo_tok_s:
                tracer.instant("slo_violation", "(engine)",
                               f"tokens_per_s observed={rate:.1f} target={slo_tok_s:g}")
        if slo_queue is not None and len(backlog) > slo_queue:
            tracer.instant("slo_violation", "(engine)",
                           f"queue_depth observed={len(backlog)} target={slo_queue:g}")
        slo_prev["tokens"] = toks
        slo_prev["ttft"] = counts

    # The SLO-driven K autotuner (DORA_AUTOTUNE_K=1): TTFT burn or shedding
    # steps K down a ladder rung and pauses speculation; a saturated window
    # (tokens a dispatch >= 3/4 of K) with no burn steps it up and resumes
    # it. A signal must hold DORA_AUTOTUNE_HYSTERESIS intervals, a retune
    # cools down as many, and nothing acts before the burn window has its
    # full complement of samples.
    at_on = (os.environ.get("DORA_AUTOTUNE_K", "") == "1" and hasattr(engine, "set_window")
             and getattr(engine, "_window_factory", None) is not None)
    at_interval = float(os.environ.get("DORA_AUTOTUNE_INTERVAL_S", "5") or 5)
    at_hyst = max(1, int(os.environ.get("DORA_AUTOTUNE_HYSTERESIS", "2") or 2))
    at_burn_win = float(os.environ.get("DORA_AUTOTUNE_BURN_WINDOW_S", "60") or 60)
    window_now = getattr(engine, "window", 1)
    try:
        at_ladder = sorted({int(x) for x in os.environ.get(
            "DORA_AUTOTUNE_LADDER", "4,8,16").split(",") if int(x) >= 1} | {window_now})
    except ValueError:
        at_ladder = sorted({4, 8, 16} | {window_now})
    at_state = {"t": None, "tokens": 0, "dispatches": 0, "ttft": [], "samples": 0, "burn": 0,
                "calm": 0, "cooldown": 0, "shed": 0, "rung": at_ladder.index(window_now)}

    def autotune(now: float) -> None:
        if not at_on:
            return
        if at_state["t"] is None:
            at_state.update(t=now, tokens=metrics.decode_tokens,
                            dispatches=metrics.host_dispatches,
                            ttft=list(metrics.ttft.counts), shed=metrics.shed)
            return
        if now - at_state["t"] < at_interval:
            return
        d_tok = metrics.decode_tokens - at_state["tokens"]
        d_disp = metrics.host_dispatches - at_state["dispatches"]
        d_shed = metrics.shed - at_state["shed"]
        counts = list(metrics.ttft.counts)
        d_ttft = [c - p for c, p in zip(counts, at_state["ttft"])]
        at_state.update(t=now, tokens=metrics.decode_tokens, dispatches=metrics.host_dispatches,
                        ttft=counts, shed=metrics.shed)
        at_state["samples"] += 1
        burn = d_shed > 0
        if slo_ttft_ms is not None and any(d > 0 for d in d_ttft):
            p99 = percentile_from_counts(d_ttft, 99)
            if p99 is not None and p99 > slo_ttft_ms * 1000.0:
                burn = True
        tpd = (d_tok / d_disp) if d_disp else 0.0
        k_now = at_ladder[at_state["rung"]]
        if burn:
            at_state["burn"] += 1
            at_state["calm"] = 0
        elif d_disp and tpd >= 0.75 * k_now:
            at_state["calm"] += 1
            at_state["burn"] = 0
        else:
            at_state["burn"] = at_state["calm"] = 0
        if not burn_window_complete(at_state["samples"], at_burn_win, at_interval):
            return
        if at_state["cooldown"] > 0:
            at_state["cooldown"] -= 1
            return
        if at_state["burn"] >= at_hyst and at_state["rung"] > 0:
            new_rung, spec_on = at_state["rung"] - 1, False
            reason = "shed" if d_shed > 0 else "ttft_burn"
        elif at_state["calm"] >= at_hyst and at_state["rung"] < len(at_ladder) - 1:
            new_rung, spec_on, reason = at_state["rung"] + 1, True, "decode_heavy"
        else:
            return
        new_k = at_ladder[new_rung]
        if not engine.set_window(new_k, spec_on=spec_on):
            return
        at_state.update(rung=new_rung, burn=0, calm=0, cooldown=at_hyst)
        metrics.retunes += 1
        metrics.autotune_k = new_k
        tracer.instant("k_retune", "(engine)",
                       f"K {k_now}->{new_k} spec_k={engine.spec_k} reason={reason} "
                       f"tpd={tpd:.2f}")

    # The device plane: memory gauges at report cadence, the engine's
    # attribution and FLOPs counters, and mfu / device_busy_fraction from
    # the interval deltas.
    monitor = (profiling.DeviceMonitor(getattr(engine, "device", None))
               if profiling.monitor_enabled() else None)
    util_prev = {"busy_ns": 0, "flops": 0, "t": clock()}
    #: on-demand deep capture: start arms a deadline checked at report
    #: cadence; stop (or the deadline) reports the artifact to the daemon
    profile_state: dict = {"active": False, "dir": "", "deadline": 0.0, "start_error": None}

    def _report_profile(artifact: str, error: str | None) -> None:
        try:
            node.report_profile(artifact, error)
        except Exception:
            pass  # captures are best-effort: serving never blocks on them

    def _finish_profile() -> None:
        artifact = profiling.stop_capture(profile_state["dir"], profile_state["start_error"])
        profile_state["active"] = False
        profile_state["start_error"] = None
        tracer.instant("profile_stop", "(engine)", artifact)
        _report_profile(artifact, None)

    def handle_profile(event) -> None:
        md = event.get("metadata") or {}
        action = md.get("action", "")
        if action == "start":
            if profile_state["active"]:
                _report_profile("", "capture already active")
                return
            out_dir = os.path.join(profiling.profile_dir(),
                                   f"capture-{os.getpid()}-{int(time.time())}")
            profile_state["dir"] = out_dir
            profile_state["start_error"] = profiling.start_capture(out_dir)
            profile_state["active"] = True
            profile_state["deadline"] = clock() + float(md.get("seconds") or 0.0)
            tracer.instant("profile_start", "(engine)", out_dir)
        elif action == "stop":
            if profile_state["active"]:
                _finish_profile()
            else:
                _report_profile("", "no capture active")

    fleet_pub = fleet.DigestPublisher(
        node, engine, tracer=tracer, clock=clock,
        hbm=lambda: (metrics.hbm_used_bytes or 0, metrics.hbm_limit_bytes or 0))

    def report(now: float) -> None:
        metrics.slots_active = engine.active
        metrics.slots_total = engine.max_slots
        metrics.backlog_depth = len(backlog)
        metrics.prefill_chunks = getattr(engine, "chunks_run", 0)
        metrics.host_dispatches = engine.dispatches
        metrics.host_fetches = engine.fetches
        metrics.compiles = engine.graph_captures
        if paged:
            alloc = engine.allocator
            metrics.free_pages = engine.free_pages
            metrics.total_pages = alloc.num_pages - 1
            metrics.used_pages = alloc.in_use
            metrics.peak_used_pages = alloc.peak_in_use
            metrics.largest_contig_free = alloc.largest_contiguous_free()
            pc = engine.prefix_cache
            if pc is not None:
                metrics.prefix_hits = pc.hits
                metrics.prefix_misses = pc.misses
                metrics.prefix_hit_tokens = pc.hit_tokens
                metrics.prefix_cached_pages = pc.size
                metrics.prefix_shared_pages = engine.shared_pages
                metrics.prefix_cow_copies = pc.cow_copies
                metrics.prefix_evictions = pc.evicted_pages
            metrics.kv_dtype = engine.kv_dtype
            metrics.kv_pool_bytes = engine.kv_pool_bytes()
            metrics.kv_quant_err = engine.kv_quant_error()
            lp = engine.lora
            if lp is not None:
                metrics.lora_resident = lp.resident
                metrics.lora_max_resident = lp.max_resident
                metrics.lora_resident_bytes = lp.resident_bytes()
                metrics.lora_loads = lp.loads
                metrics.lora_evictions = lp.evictions
                metrics.adapter_streams = lp.streams_by_adapter()
        metrics.qos_depth = backlog.depths()
        metrics.autotune_k = getattr(engine, "window", 0)
        if monitor is not None:
            for name in ("device_compute_ns", "host_dispatch_ns", "device_fetch_ns",
                         "dispatched_flops", "useful_flops"):
                setattr(metrics, name, getattr(engine, name))
            mem = monitor.memory()
            metrics.hbm_used_bytes = mem["used"]
            metrics.hbm_limit_bytes = mem["limit"]
            metrics.hbm_peak_bytes = mem["peak"]
            dt = now - util_prev["t"]
            if dt > 0:
                d_busy = metrics.device_compute_ns - util_prev["busy_ns"]
                metrics.device_busy_fraction = min(1.0, max(0.0, d_busy / (dt * 1e9)))
                d_flops = metrics.useful_flops - util_prev["flops"]
                peak = engine.device_peak_flops
                metrics.mfu = min(1.0, (d_flops / dt) / peak) if peak > 0 else None
            util_prev.update(busy_ns=metrics.device_compute_ns, flops=metrics.useful_flops,
                             t=now)
        if profile_state["active"] and now >= profile_state["deadline"]:
            _finish_profile()
        check_slo(now)
        autotune(now)
        try:
            node.report_serving(metrics.snapshot())
        except Exception:
            pass  # metrics are best-effort: serving never blocks on them
        fleet_pub.tick(now)

    # -- recovery: checkpoint and restore, drain and migrate, SIGTERM ------

    def write_checkpoint(reason: str) -> None:
        """Snapshot what a restarted node needs to resume mid-generation,
        atomically (a temporary file, then a rename). Only at a window
        boundary after the step's emits: a restore replays duplicates,
        never leaves gaps."""
        t0 = clock()
        state = {
            "engine": engine.checkpoint_state(),
            "backlog": [[k, list(ids), mn, cls, ad] for k, ids, mn, cls, ad in backlog.pending()],
            "wire_ids": dict(wire_ids),
            "seqs": dict(seqs),
            "ctxs": {k: tracer.context(k) for k in wire_ids},
            "req_counter": req_counter[0],
            "seen_rids": list(seen_rids),
        }
        os.makedirs(ckpt_dir, exist_ok=True)
        tmp = os.path.join(ckpt_dir, "state.json.tmp")
        with open(tmp, "w") as f:
            json.dump(state, f)
        os.replace(tmp, os.path.join(ckpt_dir, "state.json"))
        if os.environ.get("DORA_CHECKPOINT_PAGES") == "1":
            # The KV pools, for engines whose decode reads them. Best effort,
            # as in the JAX node: failing to persist them must not stop
            # serving.
            try:
                engine.save_pools(os.path.join(ckpt_dir, "pools"))
            except Exception:
                pass
        metrics.checkpoints += 1
        metrics.last_checkpoint_unix = time.time()
        tracer.span("s_checkpoint", "(engine)",
                    f"streams={len(state['engine']['slots'])} {reason}",
                    dur_ns=int((clock() - t0) * 1e9))

    def restore_checkpoint() -> None:
        spath = os.path.join(ckpt_dir, "state.json")
        if not os.path.exists(spath):
            return
        t0 = clock()
        with open(spath) as f:
            saved = json.load(f)
        pools = os.path.join(ckpt_dir, "pools")
        if os.environ.get("DORA_CHECKPOINT_PAGES") == "1" and os.path.isfile(pools):
            try:
                engine.restore_pools(pools)
            except Exception:
                pass  # best effort, as in the JAX node
        req_counter[0] = int(saved.get("req_counter", 0))
        wire_ids.update(saved.get("wire_ids") or {})
        seqs.update({k: int(v) for k, v in (saved.get("seqs") or {}).items()})
        for rid in saved.get("seen_rids") or []:
            seen_rids[rid] = None
        # The same context, so the same trace id: a resumed stream's spans
        # continue its chain.
        for k, ctx in (saved.get("ctxs") or {}).items():
            tracer.begin(k, ctx or "")
        restored = engine.restore_state(saved.get("engine") or {"slots": []})
        for entry in saved.get("backlog") or []:
            # [key, ids, max_new(, class(, adapter))]; the wait clock and any
            # deadline start again.
            backlog.push(entry[0], list(entry[1]), int(entry[2]),
                         entry[3] if len(entry) > 3 else None,
                         adapter=entry[4] if len(entry) > 4 else None)
        metrics.restored_streams += len(restored)
        tracer.span("s_restore", "(engine)", f"streams={len(restored)}",
                    dur_ns=int((clock() - t0) * 1e9))

    migrations = [0]

    def handle_migrate(event) -> None:
        """Drain every live stream and the parked backlog into a handoff
        file that a peer's ``DORA_MIGRATE_DIR`` poll admits; at a window
        boundary, so a client sees at most one window more of latency."""
        handoff_dir = (event.get("metadata") or {}).get("handoff_dir", "")
        if not handoff_dir:
            return
        t0 = clock()
        state = engine.drain_streams()
        parked = backlog.take_all()
        keys = [m["request_id"] for m in state["slots"]] + [entry[0] for entry in parked]
        payload = {
            "engine": state,
            "backlog": [[k, list(ids), mn, cls, ad] for k, ids, mn, cls, ad in parked],
            "wire_ids": {k: wire_ids.get(k) for k in keys},
            "seqs": {k: seqs.get(k, 0) for k in keys},
            "ctxs": {k: tracer.context(k) for k in keys},
        }
        migrations[0] += 1
        fname = f"streams-{os.getpid()}-{migrations[0]}.json"
        os.makedirs(handoff_dir, exist_ok=True)
        tmp = os.path.join(handoff_dir, fname + ".tmp")
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, os.path.join(handoff_dir, fname))
        dur = int((clock() - t0) * 1e9)
        for k in keys:
            # The span before the release, so it carries the stream's trace
            # id; no s_finish: the stream moved, it did not end.
            tracer.span("s_migrate_out", k, f"dir={handoff_dir}", dur_ns=dur)
            tracer.release(k)
            wire_ids.pop(k, None)
            seqs.pop(k, None)
            t_admitted.pop(k, None)
            _forget(k)
        metrics.migrated_out += len(keys)

    def _admit_handoff(payload: dict, src: str) -> None:
        t0 = clock()
        mapping: dict[str, str] = {}

        def fresh(old: str) -> str:
            # Another engine's req-N could collide with ours: every incoming
            # stream gets a fresh local key; the wire id and seq travel as
            # they are.
            req_counter[0] += 1
            mapping[old] = f"req-{req_counter[0]}"
            return mapping[old]

        state = payload.get("engine") or {"slots": []}
        for m in state["slots"]:
            m["request_id"] = fresh(m["request_id"])
        parked = [(fresh(entry[0]), list(entry[1]), int(entry[2]),
                   entry[3] if len(entry) > 3 else None,
                   entry[4] if len(entry) > 4 else None)
                  for entry in payload.get("backlog") or []]
        src_wire = payload.get("wire_ids") or {}
        src_seqs = payload.get("seqs") or {}
        src_ctxs = payload.get("ctxs") or {}
        for old, nk in mapping.items():
            wire_ids[nk] = src_wire.get(old)
            seqs[nk] = int(src_seqs.get(old, 0))
            tracer.begin(nk, src_ctxs.get(old) or "")  # one trace across both engines
        try:
            engine.admit_streams(state)
        except RuntimeError:
            # Capacity went between the peek and the claim (local admissions
            # came first). The restore is not transactional: roll back what
            # it admitted, then close every handoff stream with a retriable
            # "error".
            fresh_keys = set(mapping.values())
            for b, s in enumerate(engine.slots):
                if s is not None and s.request_id in fresh_keys:
                    if b in engine._prefillq:
                        engine._prefillq.remove(b)
                    engine._free_slot(b)
            for nk in mapping.values():
                metrics.rejected += 1
                tracer.instant("s_reject", nk, f"migrate-in overflow {src}")
                emit_text(nk, "", True, finish="error")
            return
        for nk, ids, mn, cls, ad in parked:
            backlog.push(nk, ids, mn, cls, adapter=ad)
        dur = int((clock() - t0) * 1e9)
        for nk in mapping.values():
            tracer.span("s_migrate_in", nk, f"from={src}", dur_ns=dur)
        metrics.migrated_in += len(mapping)

    def _handoff_fits(payload: dict) -> bool:
        """Can this engine admit every stream of the handoff now? Decoding
        streams take as many pages as their source granted; mid-prefill
        ones re-submit through the admission arithmetic."""
        metas = (payload.get("engine") or {}).get("slots") or []
        if len(metas) > engine.free_slots:
            return False

        def servable(adapter) -> bool:
            return not adapter or (engine.lora is not None and engine.lora.has(adapter))

        pages = 0
        for m in metas:
            if not servable(m.get("adapter")):
                return False  # left on disk for a peer that serves the tenant
            if m.get("decode"):
                n = len(m.get("pages") or ())
                if n * engine.page_size > engine.max_seq:
                    return False  # the block table is too short for it
                pages += n
            else:
                plen, mn = len(m.get("prompt") or ()), int(m.get("max_new", 0))
                if not engine.fits(plen, mn):
                    return False
                pages += engine.pages_needed(plen, mn)
        if not all(servable(entry[4] if len(entry) > 4 else None)
                   for entry in payload.get("backlog") or []):
            return False
        return pages <= engine.free_pages

    def poll_migrate_in() -> None:
        try:
            names = sorted(os.listdir(migrate_dir))
        except OSError:
            return
        for fname in names:
            if not (fname.startswith("streams-") and fname.endswith(".json")):
                continue
            path = os.path.join(migrate_dir, fname)
            # Peek before claiming: a handoff this engine cannot admit stays
            # on disk for a bigger peer, or for a later poll. Handoff files
            # are written once (a temporary file, then a rename), so what is
            # peeked is what is claimed.
            try:
                with open(path) as f:
                    payload = json.load(f)
            except (OSError, ValueError):
                continue
            if not _handoff_fits(payload):
                tracer.instant("s_migrate_defer", fname,
                               f"free_slots={engine.free_slots} free_pages={engine.free_pages}")
                continue
            claimed = path + ".claimed"
            try:
                os.rename(path, claimed)  # the atomic claim
            except OSError:
                continue  # a peer claimed it first
            _admit_handoff(payload, fname)
            os.remove(claimed)

    stop_now = [False]
    step_count = [0]
    engine_failed = [False]

    def on_tick() -> bool:
        if migrate_dir:
            poll_migrate_in()
        if stop_now[0]:
            if ckpt_dir:
                write_checkpoint("sigterm")
            return True
        return False

    def on_step() -> None:
        step_count[0] += 1
        if ckpt_every > 0 and step_count[0] % ckpt_every == 0:
            write_checkpoint("cadence")

    def on_engine_error() -> None:
        # A wedged engine must not leave streams dangling: every in-flight
        # request closes with a retriable "error" before the exception
        # propagates.
        engine_failed[0] = True
        for key in list(wire_ids):
            try:
                emit_text(key, "", True, finish="error")
            except Exception:
                pass

    if ckpt_dir:
        import signal

        def _term(signum, frame):
            # Checkpoint and leave at the next tick, not mid-window.
            stop_now[0] = True

        try:
            signal.signal(signal.SIGTERM, _term)
        except ValueError:
            pass  # not the main thread: the caller delivers no signals here
        restore_checkpoint()

    clean = False
    try:
        _run_loop(node, engine, backlog, metrics, handle_input, emit, report, clock=clock,
                  on_tick=on_tick if (ckpt_dir or migrate_dir) else None,
                  on_step=on_step if ckpt_dir else None,
                  handle_migrate=handle_migrate if can_ckpt else None,
                  handle_profile=handle_profile, on_engine_error=on_engine_error,
                  keep_alive=bool(migrate_dir),
                  fleet_tick=fleet_pub.tick if fleet_pub.enabled else None)
        clean = True
    finally:
        try:
            # Only a clean exit snapshots: after a crash the last cadence
            # checkpoint is the state to trust.
            if ckpt_dir and clean and not engine_failed[0]:
                write_checkpoint("exit")
        finally:
            report(clock())
            node.close()


def _stub_main(device: str) -> None:
    """Serve the weight-free stub engine (``DORA_STUB_ENGINE=1``): the real
    admission, backlog, tracing and reporting paths over
    ``batch_engine.make_stub_paged_engine``. Tokens are the stub's affine
    chain rendered as `` t<id>``; ``DORA_STUB_CYCLE=N`` swaps in the
    period-N rule, ``DORA_STEP_DELAY_S`` sleeps that long before each step."""
    from dora_tpu_torch.metrics import ServingMetrics
    from dora_tpu_torch.models.batch_engine import make_stub_paged_engine
    from dora_tpu_torch.node import Node

    cycle_env = os.environ.get("DORA_STUB_CYCLE", "")
    engine = make_stub_paged_engine(
        max_slots=int(os.environ.get("DORA_BATCH_SLOTS", "4")),
        window=int(os.environ.get("DORA_MULTISTEP_K", "4")),
        spec_k=int(os.environ.get("DORA_SPEC_K", "0") or 0),
        spec_ngram=int(os.environ.get("DORA_SPEC_NGRAM", "2") or 2),
        cycle=int(cycle_env) if cycle_env else None,
        prefix_cache=os.environ.get("DORA_PREFIX_CACHE", "1") != "0",
        prefix_cache_pages=int(os.environ.get("DORA_PREFIX_CACHE_PAGES", "0") or 0),
        lora_max_resident=int(os.environ.get("DORA_LORA_MAX_RESIDENT", "0") or 0),
        device=device,
    )
    delay = float(os.environ.get("DORA_STEP_DELAY_S", "0") or 0)
    if delay > 0:
        inner_step = engine.step

        def _throttled_step():
            time.sleep(delay)
            return inner_step()

        engine.step = _throttled_step
    serve(Node(), engine, ServingMetrics(engine="paged"),
          encode=lambda text: [ord(ch) % 97 for ch in text] or [1],
          decode_one=lambda t: f" t{t}",
          max_new_cap=int(os.environ.get("DORA_MAX_NEW_TOKENS", "8")))


def _serve_node(device: str) -> None:
    """The dataflow node: ``serve(Node(), ...)`` on the engine
    :func:`make_engine` builds over ``DORA_HF_CHECKPOINT`` (the JAX
    ``main``), or on the stub with ``DORA_STUB_ENGINE=1``."""
    from dora_tpu_torch.metrics import ServingMetrics
    from dora_tpu_torch.models import tokenizer as bytecodec
    from dora_tpu_torch.models.hf import qwen2
    from dora_tpu_torch.node import Node
    from dora_tpu_torch.nodehub.ops import _hf_tokenizer

    path = os.environ.get("DORA_HF_CHECKPOINT")
    if not path:
        if os.environ.get("DORA_STUB_ENGINE", "") not in ("", "0"):
            return _stub_main(device)
        raise RuntimeError("llm_server needs DORA_HF_CHECKPOINT (a Qwen2-family safetensors "
                           "directory; or DORA_STUB_ENGINE=1 for the weight-free stub engine)")
    max_seq = int(os.environ.get("DORA_MAX_SEQ", "2048"))
    max_new_cap = int(os.environ.get("DORA_MAX_NEW_TOKENS", "32"))
    cfg, params = qwen2.load(path, max_seq=max_seq, device=device)
    if not os.environ.get("DORA_INT8_DECODE") and not os.environ.get("DORA_INT4_DECODE"):
        os.environ["DORA_INT8_DECODE"] = "1"  # the fused layout; the fleet digest reads it
    params = qwen2.quantize_decode(params, cfg)
    tok = _hf_tokenizer(path)
    eos = eos_token(tok)

    def encode(text: str) -> list[int]:
        if tok is not None:
            return tok.encode(text)
        return [t % cfg.vocab for t in bytecodec.encode(text)]

    def decode_one(token: int) -> str:
        return (tok or bytecodec).decode([token])

    engine = make_engine(params, cfg, eos=eos, device=device)
    metrics = ServingMetrics(engine="paged" if hasattr(engine, "free_pages") else "dense")
    serve(Node(), engine, metrics, encode=encode, decode_one=decode_one, eos=eos,
          max_new_cap=max_new_cap)


def main(argv=None) -> int:
    from dora_tpu_torch.models.hf import qwen2

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--prompts", help="JSON file: a list of token-id lists to answer without "
                                      "a dataflow (absent: run as the dataflow node)")
    ap.add_argument("--max-new", type=int,
                    default=int(os.environ.get("DORA_MAX_NEW_TOKENS", "32")))
    ap.add_argument("--random-config", choices=sorted(qwen2.CONFIGS),
                    help="with --prompts: seeded random weights at this config")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.prompts is None:
        if args.random_config:
            ap.error("--random-config takes --prompts; the node serves DORA_HF_CHECKPOINT")
        _serve_node(args.device)
        return 0
    max_seq = int(os.environ.get("DORA_MAX_SEQ", "2048"))
    eos = None
    if args.random_config:
        cfg = qwen2.CONFIGS[args.random_config](max_seq=max_seq)
        params = qwen2.random_params(cfg, seed=args.seed, device=args.device)
    else:
        from dora_tpu_torch.nodehub.ops import _hf_tokenizer

        path = os.environ.get("DORA_HF_CHECKPOINT")
        if not path:
            ap.error("set DORA_HF_CHECKPOINT or pass --random-config")
        cfg, params = qwen2.load(path, max_seq=max_seq, device=args.device)
        eos = eos_token(_hf_tokenizer(path))
    params = qwen2.quantize_decode(params, cfg)

    with open(args.prompts) as f:
        prompts = [[int(t) for t in p] for p in json.load(f)]
    engine = make_engine(params, cfg, eos=eos, device=args.device)
    out, ttft = serve_prompts(engine, prompts, args.max_new)
    for i in range(len(prompts)):
        print(json.dumps({"id": i, "ttft_s": ttft.get(i), "tokens": out[i]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
