"""The port's serving node (dora_tpu_torch/nodehub/llm_server.py) against
dora_tpu's, on the CPU.

The same scripted input events, under the same fake clock (it advances a
fixed step at every ``recv``), go through the JAX ``serve()`` on the JAX
package's stub engine and through the port's ``serve()`` on the port's
stub: every chunk sent (output, text and metadata) and every counter of the
serving metrics must be equal. The scenarios are those of
tests/test_llm_backlog.py and tests/test_qos.py: backlog, aging, depth and
deadline shedding, preemption and resume (with and without the prefix
cache, speculation, fused windows), LoRA tenants, rejections, and the K
autotuner's ``set_window`` mid-stream. Then the tiny random Qwen2: JAX
``serve`` on JAX ``make_engine`` against the port's on
``make_engine(device="cpu")``, preemption on, text per request equal. The
recovery knobs serve as in JAX (their scenarios are
tests/test_torch_serve_recovery.py's).
"""

from __future__ import annotations

import json
import os
import signal

import pytest
import torch

#: fake seconds a ``recv`` call advances the clock (by default)
DT = 0.01

#: snapshot keys that hold host times or the process's device state, which
#: two runs never share (the histograms' counts are compared instead)
TIMED_KEYS = ("ttft_us", "fetch_us", "compiles", "device_compute_ns", "host_dispatch_ns",
              "device_fetch_ns", "hbm_used_bytes", "hbm_limit_bytes", "hbm_peak_bytes", "mfu",
              "device_busy_fraction", "checkpoint_age_s")


class ScriptedNode:
    """A node fake: input events in order, one per ``recv``, each held back
    until its gate (a predicate over the chunks sent so far) opens; a fake
    clock that advances DT per ``recv``; sent chunks captured as (output id,
    text, metadata)."""

    def __init__(self, events, dt: float = DT):
        self._events = list(events)
        self.dt = dt
        self.t = [0.0]
        self.stream_ended = False
        self.sent: list[tuple[str, str, dict]] = []
        self.snapshots: list[dict] = []
        self.closed = False

    def clock(self) -> float:
        return self.t[0]

    def recv(self, timeout=None):
        self.t[0] += self.dt
        if self._events:
            gate, event = self._events[0]
            if gate is None or gate(self.sent):
                self._events.pop(0)
                return event
            return None
        self.stream_ended = True
        return None

    def send_output(self, output_id, value, metadata=None):
        text = value.to_pylist()[0] if hasattr(value, "to_pylist") else value[0]
        self.sent.append((output_id, text, dict(metadata or {})))

    def report_serving(self, snapshot):
        self.snapshots.append(snapshot)

    def report_profile(self, artifact, error=None):
        pass

    def close(self):
        self.closed = True


def _req(rid, text, max_new, qos=None, **meta):
    md = {"request_id": rid, "max_new_tokens": max_new, **meta}
    if qos:
        md["qos_class"] = qos
    return {"type": "INPUT", "metadata": md, "value": text.encode()}


def after_first_token(rid):
    """A gate: open once ``rid`` has a token chunk out."""
    return lambda sent: any(m.get("request_id") == rid and not m.get("done")
                            for _o, _t, m in sent)


def _stub_serve(serve_fn, metrics_cls, engine, events, dt=DT, max_new_cap=64):
    node = ScriptedNode(events, dt)
    metrics = metrics_cls(engine="paged")
    serve_fn(node, engine, metrics, encode=lambda text: [ord(ch) % 97 + 1 for ch in text] or [1],
             decode_one=lambda tok: f" t{tok}", max_new_cap=max_new_cap, clock=node.clock)
    assert node.closed
    return node, metrics


def _comparable(snapshot: dict) -> dict:
    out = {k: v for k, v in snapshot.items() if k not in TIMED_KEYS}
    out["ttft_count"] = snapshot["ttft_us"]["count"]
    out["fetch_count"] = snapshot["fetch_us"]["count"]
    return out


#: scenario -> (stub engine kwargs, env, events as (gate, event) pairs[, the
#: node's clock step and max_new_cap])
SCENARIOS = {
    "backlog": (dict(max_slots=1, window=4),
                {},
                [(None, _req("a", "first", 6)), (None, _req("b", "second", 5)),
                 (None, _req("c", "third", 3))]),
    "aging": (dict(max_slots=1, window=2),
              {"DORA_QOS_AGING_S": "0.05"},
              [(None, _req("b0", "bulk", 6, "batch")), (None, _req("b1", "bulk two", 4, "batch")),
               (None, _req("i0", "hi", 3, "interactive")),
               (None, _req("i1", "hey", 3, "interactive")),
               (None, _req("s0", "std", 3))]),
    "depth_shed": (dict(max_slots=1, window=2),
                   {"DORA_QOS_DEPTH_BATCH": "1"},
                   [(None, _req("w-hold", "occupy the slot", 10, "batch")),
                    (None, _req("w-park", "parks in batch", 4, "batch")),
                    (None, _req("w-shed", "overflows the bound", 4, "batch"))]),
    "deadline_shed": (dict(max_slots=1, window=1),
                      {"DORA_QOS_SHED_WAIT_MS": "60"},
                      [(None, _req("long", "a long one", 20)),
                       (None, _req("late", "waits", 4)),
                       (None, _req("tight", "tight", 4, deadline_ms=25))]),
    "preempt_k1": (dict(max_slots=1, window=1, max_seq=128),
                   {"DORA_QOS_PREEMPT": "1"},
                   [(None, _req("w-b", "hello world", 24, "batch")),
                    (after_first_token("w-b"), _req("w-i", "quick", 4, "interactive"))]),
    "preempt_k8_spec": (dict(max_slots=1, window=8, spec_k=2, max_seq=128),
                        {"DORA_QOS_PREEMPT": "1"},
                        [(None, _req("w-b", "hello world", 24, "batch")),
                         (after_first_token("w-b"), _req("w-i", "quick", 4, "interactive"))]),
    "preempt_prefix_cache": (dict(max_slots=1, window=4, max_seq=128, prefix_cache=True),
                             {"DORA_QOS_PREEMPT": "1"},
                             [(None, _req("w-b", "0123456789abcdef", 20, "batch")),
                              (after_first_token("w-b"), _req("w-i", "hi", 3, "interactive"))]),
    "overload_two_slots": (dict(max_slots=2, window=4, max_seq=128),
                           {"DORA_QOS_PREEMPT": "1"},
                           [(None, _req(f"w-b{n}", f"bulk request {n}", 12, "batch"))
                            for n in range(6)]
                           + [(None, _req(f"w-i{n}", f"hi {n}", 3, "interactive"))
                              for n in range(3)]),
    "tenants_and_rejects": (dict(max_slots=2, window=2, max_seq=64, lora_max_resident=1),
                            {},
                            [(None, _req("t-a", "tenant a", 5, model="alpha")),
                             (None, _req("t-b", "tenant b", 5, model="beta")),
                             (None, _req("base", "base model", 4, model="dora-tpu")),
                             (None, _req("zero", "nothing", 0)),
                             (None, _req("huge", "x" * 70, 4))]),
    "spec_cycle": (dict(max_slots=2, window=4, spec_k=3, cycle=5, max_seq=128),
                   {},
                   [(None, _req("c0", "abcabc", 30)), (None, _req("c1", "zzz", 25))]),
    "autotune_set_window": (dict(max_slots=2, window=4, max_seq=256),
                            {"DORA_AUTOTUNE_K": "1", "DORA_AUTOTUNE_INTERVAL_S": "0.05",
                             "DORA_AUTOTUNE_BURN_WINDOW_S": "0.05",
                             "DORA_AUTOTUNE_HYSTERESIS": "1", "DORA_AUTOTUNE_LADDER": "4,8"},
                            [(None, _req("long0", "decode heavy", 200)),
                             (None, _req("long1", "decode heavier", 200))],
                            dict(dt=0.2, max_new_cap=200)),
}


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_serve_on_the_stub_matches_jax(monkeypatch, scenario):
    from dora_tpu.metrics import ServingMetrics as JaxMetrics
    from dora_tpu.models.batch_engine import make_stub_paged_engine as jax_stub
    from dora_tpu.nodehub.llm_server import serve as jax_serve
    from dora_tpu_torch.metrics import ServingMetrics
    from dora_tpu_torch.models.batch_engine import make_stub_paged_engine
    from dora_tpu_torch.nodehub.llm_server import serve

    kwargs, env, events, *opts = SCENARIOS[scenario]
    monkeypatch.setenv("DORA_FLEET_DIGEST_S", "0")
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    jnode, jm = _stub_serve(jax_serve, JaxMetrics, jax_stub(**kwargs), events, **(opts or [{}])[0])
    tnode, tm = _stub_serve(serve, ServingMetrics,
                            make_stub_paged_engine(**kwargs, device="cpu"), events,
                            **(opts or [{}])[0])
    assert tnode.sent == jnode.sent
    finals = [m for _o, _t, m in tnode.sent if m["done"]]
    # Every request ends in exactly one done chunk, with seq running on.
    assert len(finals) == len({e["metadata"]["request_id"] for _g, e in events})
    assert _comparable(tm.snapshot()) == _comparable(jm.snapshot())
    assert len(tnode.snapshots) == len(jnode.snapshots)


SCENARIO_PROPERTIES = {
    "depth_shed": lambda m: m.shed >= 1,
    "deadline_shed": lambda m: m.shed >= 1,
    "preempt_k1": lambda m: m.preempted >= 1 and m.resumed >= 1,
    "preempt_k8_spec": lambda m: m.preempted >= 1 and m.resumed >= 1 and m.spec_drafted > 0,
    "preempt_prefix_cache": lambda m: m.preempted >= 1 and m.prefix_hits >= 1,
    "overload_two_slots": lambda m: m.preempted >= 1,
    "tenants_and_rejects": lambda m: m.rejected == 2 and m.lora_loads >= 2,
    "spec_cycle": lambda m: m.spec_accepted > m.spec_drafted // 2,
    "autotune_set_window": lambda m: m.retunes >= 1 and m.autotune_k == 8,
}


@pytest.mark.parametrize("scenario", sorted(SCENARIO_PROPERTIES))
def test_scenario_exercises_its_path(monkeypatch, scenario):
    """Each scenario reaches the path it is named for (on the port)."""
    from dora_tpu_torch.metrics import ServingMetrics
    from dora_tpu_torch.models.batch_engine import make_stub_paged_engine
    from dora_tpu_torch.nodehub.llm_server import serve

    kwargs, env, events, *opts = SCENARIOS[scenario]
    monkeypatch.setenv("DORA_FLEET_DIGEST_S", "0")
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    _node, metrics = _stub_serve(serve, ServingMetrics,
                                 make_stub_paged_engine(**kwargs, device="cpu"), events,
                                 **(opts or [{}])[0])
    assert SCENARIO_PROPERTIES[scenario](metrics), metrics.snapshot()


# ---------------------------------------------------------------------------
# the admission queue and the loop alone, on both packages
# ---------------------------------------------------------------------------


def _impl(name):
    if name == "jax":
        from dora_tpu.nodehub import llm_server
    else:
        from dora_tpu_torch.nodehub import llm_server
    return llm_server


class SlotEngine:
    """Slot-count-only engine (tests/test_qos.py's)."""

    def __init__(self, slots: int = 1):
        self.max_slots = slots
        self.active = 0
        self.started: list[str] = []

    def fits(self, plen, max_new):
        return True

    def can_admit(self, plen, max_new):
        return self.active < self.max_slots

    def start(self, key, ids, max_new):
        self.active += 1
        self.started.append(key)

    def release(self):
        self.active -= 1


@pytest.mark.parametrize("impl", ["jax", "port"])
def test_aged_batch_head_overtakes_fresh_interactive(impl):
    m = _impl(impl)
    t = [0.0]
    engine = SlotEngine()
    engine.active = 1
    q = m.AdmissionQueue(engine, engine.start, clock=lambda: t[0],
                         qos=m.QosConfig(aging_s=1.0))
    q.push("b", [1], 2, "batch")
    for n in range(3):
        t[0] += 1.0
        q.push(f"i{n}", [1], 2, "interactive")
        engine.release()
        q.drain()
        engine.active = 1
    t[0] = 20.0
    q.push("i3", [1], 2, "interactive")
    engine.release()
    q.drain()
    assert engine.started == ["i0", "i1", "i2", "b"]
    assert q.queued("i3") and not q.queued("b")


@pytest.mark.parametrize("impl", ["jax", "port"])
def test_depth_and_deadline_shed(impl):
    m = _impl(impl)
    t = [0.0]
    engine = SlotEngine()
    engine.active = 1
    shed = []
    q = m.AdmissionQueue(engine, engine.start, clock=lambda: t[0],
                         qos=m.QosConfig(depths={"batch": 1}, shed_wait_s=10.0),
                         on_shed=lambda k, reason, w: shed.append((k, reason)))
    assert q.push("b0", [1], 2, "batch")
    assert not q.push("b1", [1], 2, "batch")
    q.push("dl", [1], 2, "standard", deadline_s=1.0)
    t[0] = 2.0
    q.drain()
    t[0] = 11.0
    q.drain()
    assert shed == [("b1", "depth:batch"), ("dl", "queue_wait"), ("b0", "queue_wait")]
    assert len(q) == 0


@pytest.mark.parametrize("impl", ["jax", "port"])
def test_preempt_hook_requeues_at_the_front_with_a_fresh_clock(impl):
    m = _impl(impl)
    t = [100.0]
    engine = SlotEngine()
    engine.active = 1
    calls = []
    q = m.AdmissionQueue(engine, engine.start, clock=lambda: t[0], qos=m.QosConfig(aging_s=1.0))

    def preempt(cls):
        calls.append(cls)
        if len(calls) > 1:
            return False
        engine.release()
        q.requeue("victim", [9], 4, "batch")
        return True

    q._preempt = preempt
    q.push("i", [1], 2, "interactive")
    assert calls[0] == "interactive" and engine.started == ["i"]
    assert q.queued("victim") and q._q["batch"][0][3] == 100.0


@pytest.mark.parametrize("impl", ["jax", "port"])
def test_qos_config_from_env(monkeypatch, impl):
    m = _impl(impl)
    monkeypatch.setenv("DORA_QOS_DEFAULT_CLASS", "interactive")
    monkeypatch.setenv("DORA_QOS_DEPTH_BATCH", "3")
    monkeypatch.setenv("DORA_QOS_SHED_WAIT_MS", "1500")
    monkeypatch.setenv("DORA_QOS_AGING_S", "5")
    monkeypatch.setenv("DORA_QOS_PREEMPT", "1")
    cfg = m.QosConfig.from_env()
    assert (cfg.default_class, cfg.depths, cfg.shed_wait_s, cfg.aging_s, cfg.preempt_on) == (
        "interactive", {"interactive": None, "standard": None, "batch": 3}, 1.5, 5.0, True)
    monkeypatch.setenv("DORA_QOS_DEFAULT_CLASS", "bogus")
    assert m.QosConfig.from_env().default_class == "standard"


class CountdownEngine:
    """tests/test_llm_backlog.py's FakeEngine: one token a stream a step;
    ``can_admit`` refuses its first ``deny_admits`` calls, which no event or
    step flips back."""

    def __init__(self, slots=1, deny_admits=0):
        self.max_slots = slots
        self.streams: dict[str, int] = {}
        self.caps: dict[str, int] = {}
        self.deny_admits = deny_admits
        self.steps = 0
        self.submits: list[tuple[str, int]] = []

    @property
    def active(self):
        return len(self.streams)

    def can_admit(self, plen, max_new):
        if self.deny_admits > 0:
            self.deny_admits -= 1
            return False
        return self.active < self.max_slots

    def submit(self, key, ids, max_new):
        self.streams[key] = 0
        self.caps[key] = max_new
        self.submits.append((key, self.steps))

    def step(self):
        self.steps += 1
        out = []
        for key in list(self.streams):
            self.streams[key] += 1
            done = self.streams[key] >= self.caps[key]
            out.append((key, 7, done))
            if done:
                del self.streams[key]
        return out


@pytest.mark.parametrize("impl", ["jax", "port"])
@pytest.mark.parametrize("deny", [0, 2])
def test_run_loop_admits_parked_requests_without_traffic(impl, deny):
    """A request parked while the only slot is busy (or while can_admit is
    refused) starts from the loop's unconditional drain, with no event left
    to push it: after the step that freed the slot, or on the idle path."""
    from dora_tpu_torch.metrics import ServingMetrics

    m = _impl(impl)

    engine = CountdownEngine(slots=1, deny_admits=deny)
    backlog = m.AdmissionQueue(engine, engine.submit)
    events = [_req("a", "a", 2)] + ([_req("b", "b", 2)] if not deny else [])
    node = ScriptedNode([(None, e) for e in events])
    emitted = []
    m._run_loop(node, engine, backlog, ServingMetrics(),
                lambda ev: backlog.push(ev["metadata"]["request_id"], [1, 2, 3], 2),
                lambda k, tok, done: emitted.append(k), lambda now: None)
    assert len(backlog) == 0
    if deny:
        assert engine.submits == [("a", 0)] and emitted == ["a", "a"]
    else:
        assert dict(engine.submits)["b"] == engine.steps - 2
        assert sorted(set(emitted)) == ["a", "b"]


# ---------------------------------------------------------------------------
# the engine's preemption on its static window buffers
# ---------------------------------------------------------------------------


def test_preempt_zeroes_the_row_in_the_window_buffers():
    """preempt frees the slot and its pages between steps; before the next
    window its row of the static block tables (which a CUDA graph replays
    over) is zeroed and its mask bit cleared, so a stale row writes to the
    null page; the survivor runs on as if alone."""
    from dora_tpu_torch.models.batch_engine import make_stub_paged_engine

    def run(preempt: bool):
        e = make_stub_paged_engine(max_slots=2, window=2, max_seq=64, device="cpu")
        e.submit("a", [5, 3, 9], 12)
        e.submit("b", [1, 2], 12)
        out = {"a": [], "b": []}
        for _ in range(3):
            for rid, tok, _d in e.step():
                out[rid].append(tok)
        if preempt:
            row = next(i for i, s in enumerate(e.slots) if s.request_id == "b")
            assert e._bt_dec[row].any()
            meta = e.preempt("b")
            assert meta == {"emitted": len(out["b"]), "max_new": 12, "pages": meta["pages"],
                            "was_decoding": True, "adapter": None}
            assert e.preempt("b") is None
            e.check_invariants()
        while e.active:
            for rid, tok, _d in e.step():
                out[rid].append(tok)
            if preempt:
                assert not e._bt_dec[row].any() and not bool(e._mask[row])
        assert e.allocator.in_use == 0
        return out

    alone, cut = run(False), run(True)
    assert cut["a"] == alone["a"]
    assert cut["b"] == alone["b"][: len(cut["b"])] and len(cut["b"]) < 12


def test_allocator_largest_contiguous_free_matches_jax():
    from dora_tpu.models.batch_engine import PageAllocator as JaxAllocator
    from dora_tpu_torch.models.batch_engine import PageAllocator

    got, want = PageAllocator(17), JaxAllocator(17)
    for a in (got, want):
        pages = a.alloc(9)
        a.free(pages[2:4] + pages[6:7])
    assert got.largest_contiguous_free() == want.largest_contiguous_free() == 7
    assert PageAllocator(2).largest_contiguous_free() == 1


# ---------------------------------------------------------------------------
# the recovery knobs
# ---------------------------------------------------------------------------


def _all_done(rids):
    return lambda sent: {m.get("request_id") for _o, _t, m in sent if m.get("done")} >= set(rids)


@pytest.mark.parametrize("knob", ["DORA_CHECKPOINT_DIR", "DORA_MIGRATE_DIR"])
def test_recovery_knobs_serve_as_in_jax(monkeypatch, tmp_path, knob):
    """With either recovery knob set the port's node serves (it refused to
    start until checkpoint and migration were ported): the same chunks,
    counters and files as the JAX node. A checkpoint directory gets the
    JAX node's state.json at each cadence step and at the exit; a migrate
    directory keeps the loop up past the inputs until STOP."""
    from dora_tpu.metrics import ServingMetrics as JaxMetrics
    from dora_tpu.models.batch_engine import make_stub_paged_engine as jax_stub
    from dora_tpu.nodehub.llm_server import serve as jax_serve
    from dora_tpu_torch.metrics import ServingMetrics
    from dora_tpu_torch.models.batch_engine import make_stub_paged_engine
    from dora_tpu_torch.nodehub.llm_server import serve

    monkeypatch.setenv("DORA_FLEET_DIGEST_S", "0")
    monkeypatch.setenv("DORA_CHECKPOINT_EVERY", "2")
    events = [(None, _req("a", "abc", 7)), (None, _req("b", "de", 5)),
              (_all_done("ab"), {"type": "STOP"})]
    prev = signal.getsignal(signal.SIGTERM)
    states = []
    try:
        for side, (serve_fn, stub, metrics_cls) in (
                ("jax", (jax_serve, jax_stub, JaxMetrics)),
                ("port", (serve, lambda **kw: make_stub_paged_engine(**kw, device="cpu"),
                          ServingMetrics))):
            monkeypatch.setenv(knob, str(tmp_path / side))
            states.append(_stub_serve(serve_fn, metrics_cls, stub(max_slots=2, window=2),
                                      events))
    finally:
        signal.signal(signal.SIGTERM, prev)
    (jnode, jm), (tnode, tm) = states
    assert tnode.sent == jnode.sent and len(tnode.sent) == 12
    assert _comparable(tm.snapshot()) == _comparable(jm.snapshot())
    if knob == "DORA_CHECKPOINT_DIR":
        assert tm.checkpoints == jm.checkpoints >= 2
        with open(tmp_path / "jax" / "state.json") as f, \
                open(tmp_path / "port" / "state.json") as g:
            assert json.load(g) == json.load(f)
    else:
        assert tm.checkpoints == 0 and not (tmp_path / "port").exists()  # polled, never written


def test_node_needs_a_checkpoint_or_the_stub(monkeypatch):
    from dora_tpu_torch.nodehub import llm_server

    monkeypatch.delenv("DORA_HF_CHECKPOINT", raising=False)
    monkeypatch.delenv("DORA_STUB_ENGINE", raising=False)
    with pytest.raises(RuntimeError, match="needs DORA_HF_CHECKPOINT"):
        llm_server.main(["--device", "cpu"])


def test_migrate_and_profile_events_on_the_port(monkeypatch, tmp_path):
    """A MIGRATE event drains the live stream into a handoff file in its
    ``handoff_dir`` (the JAX node's payload) and sends nothing more for it;
    a PROFILE start / stop pair reports the capture's artifact."""
    from dora_tpu.metrics import ServingMetrics as JaxMetrics
    from dora_tpu.models.batch_engine import make_stub_paged_engine as jax_stub
    from dora_tpu.nodehub.llm_server import serve as jax_serve
    from dora_tpu_torch.metrics import ServingMetrics
    from dora_tpu_torch.models.batch_engine import make_stub_paged_engine
    from dora_tpu_torch.nodehub.llm_server import serve

    monkeypatch.setenv("DORA_PROFILE_DIR", str(tmp_path / "profiles"))
    reports = []

    def events(side):
        return [(None, _req("a", "abc", 6)),
                (after_first_token("a"),
                 {"type": "MIGRATE", "metadata": {"handoff_dir": str(tmp_path / side)}}),
                (None, {"type": "PROFILE", "metadata": {"action": "start", "seconds": 60}}),
                (None, {"type": "PROFILE", "metadata": {"action": "stop"}}),
                (None, {"type": "PROFILE", "metadata": {"action": "stop"}})]

    jnode = ScriptedNode(events("jax"))
    jm = JaxMetrics(engine="paged")
    jax_serve(jnode, jax_stub(), jm, encode=lambda t: [1, 2, 3], decode_one=lambda t: f" t{t}",
              clock=jnode.clock)
    node = ScriptedNode(events("port"))
    node.report_profile = lambda artifact, error=None: reports.append((artifact, error))
    tm = ServingMetrics(engine="paged")
    serve(node, make_stub_paged_engine(device="cpu"), tm,
          encode=lambda t: [1, 2, 3], decode_one=lambda t: f" t{t}", clock=node.clock)
    assert node.sent == jnode.sent
    assert 0 < len(node.sent) < 6 and not any(m["done"] for _o, _t, m in node.sent)
    assert tm.migrated_out == jm.migrated_out == 1
    (jname,), (name,) = os.listdir(tmp_path / "jax"), os.listdir(tmp_path / "port")
    assert name == f"streams-{os.getpid()}-1.json" == jname
    with open(tmp_path / "jax" / jname) as f, open(tmp_path / "port" / name) as g:
        payload = json.load(g)
        assert payload == json.load(f)
    assert payload["wire_ids"] == {"req-1": "a"} and payload["seqs"] == {"req-1": len(node.sent)}
    assert len(reports) == 2 and reports[0][0].startswith(str(tmp_path / "profiles"))
    assert reports[1] == ("", "no capture active")


# ---------------------------------------------------------------------------
# the tiny random Qwen2: JAX serve on JAX make_engine against the port's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_qwen2(tmp_path_factory):
    from transformers import Qwen2Config, Qwen2ForCausalLM

    config = Qwen2Config(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, rope_theta=10000.0,
        rms_norm_eps=1e-6, tie_word_embeddings=False,
        attn_implementation="eager",
    )
    torch.manual_seed(0)
    model = Qwen2ForCausalLM(config).eval()
    path = tmp_path_factory.mktemp("qwen2-torch-serve")
    model.save_pretrained(path, safe_serialization=True)
    return path


@pytest.mark.parametrize("window", ["1", "4"])
def test_serve_on_tiny_qwen2_matches_jax_with_preemption(monkeypatch, tiny_qwen2, window):
    """Two slots, three batch requests, then two interactive ones once the
    first batch stream decodes: preemption evicts batch streams, which
    resume by re-prefilling prompt + emitted. Every request's text equals
    the JAX node's on the same weights."""
    from dora_tpu.metrics import ServingMetrics as JaxMetrics
    from dora_tpu.models import tokenizer as jax_codec
    from dora_tpu.models.hf import qwen2 as jq
    from dora_tpu.nodehub import llm_server as jax_server
    from dora_tpu_torch.metrics import ServingMetrics
    from dora_tpu_torch.models import tokenizer as codec
    from dora_tpu_torch.models.hf import qwen2 as tq
    from dora_tpu_torch.nodehub import llm_server

    for key, value in {"DORA_QOS_PREEMPT": "1", "DORA_BATCH_SLOTS": "2",
                       "DORA_MULTISTEP_K": window, "DORA_PREFILL_CHUNK": "16",
                       "DORA_FLEET_DIGEST_S": "0", "DORA_INT8_DECODE": "1"}.items():
        monkeypatch.setenv(key, value)
    cfg, params = jq.load(tiny_qwen2, max_seq=64)
    qparams = jq.quantize_decode(params, cfg)
    tcfg, _ = tq.load(tiny_qwen2, max_seq=64, device="cpu")
    tparams = tq.params_from_jax(qparams, device="cpu")
    events = ([(None, _req(f"b{n}", text, 12, "batch"))
               for n, text in enumerate(("robots dream", "hello there", "dora flows"))]
              + [(after_first_token("b0"), _req("i0", "quick", 5, "interactive")),
                 (None, _req("i1", "hi!", 5, "interactive"))])

    def texts(node):
        out: dict[str, str] = {}
        for _o, text, meta in node.sent:
            out[meta["request_id"]] = out.get(meta["request_id"], "") + text
        return out

    jnode = ScriptedNode(events)
    jm = JaxMetrics(engine="paged")
    jax_server.serve(jnode, jax_server.make_engine(qparams, cfg), jm,
                     encode=lambda t: [x % cfg.vocab for x in jax_codec.encode(t)],
                     decode_one=lambda tok: jax_codec.decode([tok]), max_new_cap=12,
                     clock=jnode.clock)
    tnode = ScriptedNode(events)
    tm = ServingMetrics(engine="paged")
    llm_server.serve(tnode, llm_server.make_engine(tparams, tcfg, device="cpu"), tm,
                     encode=lambda t: [x % tcfg.vocab for x in codec.encode(t)],
                     decode_one=lambda tok: codec.decode([tok]), max_new_cap=12,
                     clock=tnode.clock)
    assert texts(tnode) == texts(jnode)
    assert tm.preempted >= 1 and tm.resumed == tm.preempted
    assert (tm.preempted, tm.resumed, tm.decode_tokens) == (jm.preempted, jm.resumed,
                                                            jm.decode_tokens)
    assert [m for _o, _t, m in tnode.sent] == [m for _o, _t, m in jnode.sent]


@pytest.mark.parametrize("spec_k", [0, 2])
def test_stub_set_window_mid_stream_matches_jax(spec_k):
    """Retuning K and pausing / resuming speculation at window boundaries
    (the autotuner's actuator) changes no token: the port's stub engine,
    retuned mid-stream, emits the JAX stub's unretuned stream; each (K,
    spec_k) binds its window once."""
    from dora_tpu.models.batch_engine import make_stub_paged_engine as jax_stub
    from dora_tpu_torch.models.batch_engine import make_stub_paged_engine

    def run(engine, retune: bool):
        engine.submit("r", [5, 3, 9], 24)
        engine.submit("s", [7, 7, 1, 2], 20)
        out, steps = {"r": [], "s": []}, 0
        while engine.active:
            for rid, tok, done in engine.step():
                out[rid].append((tok, done))
            steps += 1
            if retune and steps == 2:
                assert engine.set_window(1, spec_on=False)
            if retune and steps == 5:
                assert engine.set_window(8, spec_on=True)
        return out

    kw = dict(max_slots=2, window=8, spec_k=spec_k, max_seq=128)
    port = make_stub_paged_engine(**kw, device="cpu")
    assert run(port, True) == run(jax_stub(**kw), False)
    assert port.graph_captures == 2 and not port.set_window(8)


def test_port_reads_no_new_knob():
    """Every DORA_* name the port reads is one the JAX package registers
    (dora_tpu/analysis/envreg.py), with its meaning: the port adds none."""
    from dora_tpu.analysis import envreg

    root = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "dora_tpu_torch")
    assert envreg.lint_env_reads(root) == []
