"""The recovery half of the port's ``serve()`` against the JAX one's, on the
CPU: checkpoint and restore, the dedup of replayed inputs, SIGTERM, drain
and migrate, the deferred and the raced migrate-in.

tests/test_checkpoint_resume.py's serve() cases, driven deterministically:
the JAX ``serve()`` on the JAX package's stub engine and the port's on the
port's stub, each under the same fake clock (it advances at every ``recv``)
and the same scripted node, which raises out of ``recv`` at a fixed call (a
kill) or delivers SIGTERM there. Everything either stack sends, the
``state.json`` it writes and its serving counters must be equal; the chunks
of the crashed and the resumed run, deduplicated by (request_id, seq),
must be the uninterrupted run's. A ``state.json`` written by either stack
restores in the other.
"""

from __future__ import annotations

import json
import os
import signal

import pytest

from tests.test_torch_llm_server import ScriptedNode, _comparable, _req, after_first_token


def _stacks():
    """{"jax": (serve, stub factory, metrics class), "port": ...}."""
    from dora_tpu.metrics import ServingMetrics as JaxMetrics
    from dora_tpu.models.batch_engine import make_stub_paged_engine as jax_stub
    from dora_tpu.nodehub.llm_server import serve as jax_serve
    from dora_tpu_torch.metrics import ServingMetrics
    from dora_tpu_torch.models.batch_engine import make_stub_paged_engine
    from dora_tpu_torch.nodehub.llm_server import serve

    return {"jax": (jax_serve, jax_stub, JaxMetrics),
            "port": (serve, lambda **kw: make_stub_paged_engine(**kw, device="cpu"),
                     ServingMetrics)}


@pytest.fixture(autouse=True)
def _keep_sigterm(monkeypatch):
    """serve() installs a SIGTERM handler in checkpoint mode: put the
    test process's back."""
    monkeypatch.setenv("DORA_FLEET_DIGEST_S", "0")
    prev = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, prev)


class CrashNode(ScriptedNode):
    """A ScriptedNode whose stream stays open; at ``recv`` call
    ``crash_at`` it raises (the in-process stand-in for kill -9) or, with
    ``sigterm``, delivers SIGTERM to this process and goes on."""

    def __init__(self, events, crash_at: int, sigterm: bool = False):
        super().__init__(events)
        self.calls = 0
        self.crash_at = crash_at
        self.sigterm = sigterm

    def recv(self, timeout=None):
        self.calls += 1
        if self.calls == self.crash_at:
            if not self.sigterm:
                raise RuntimeError("simulated kill")
            signal.raise_signal(signal.SIGTERM)
        if not self._events:
            self.t[0] += self.dt
            return None  # the stream stays open until the kill
        return super().recv(timeout)


class StopWhenIdle(ScriptedNode):
    """A migration target's node: no inputs, its stream open, and STOP once
    the engine is idle and at least ``min_polls`` calls have passed."""

    def __init__(self, engine, min_polls: int = 4):
        super().__init__([])
        self.engine = engine
        self.polls = 0
        self.min_polls = min_polls

    def recv(self, timeout=None):
        self.polls += 1
        self.t[0] += self.dt
        if self.polls >= self.min_polls and self.engine.active == 0:
            return {"type": "STOP"}
        return None


def _serve(stack: str, node, engine, metrics=None):
    serve_fn, _stub, metrics_cls = _stacks()[stack]
    metrics = metrics or metrics_cls(engine="paged")
    serve_fn(node, engine, metrics, encode=lambda text: [ord(ch) % 97 + 1 for ch in text] or [1],
             decode_one=lambda tok: f" t{tok}", max_new_cap=64, clock=node.clock)
    return metrics


def _engine(stack: str, **kw):
    return _stacks()[stack][1](**kw)


def _merge(*nodes) -> dict[str, str]:
    """The consumers' rule: the first chunk of each (request_id, seq)."""
    seen: dict[tuple[str, int], str] = {}
    for node in nodes:
        for _o, text, meta in node.sent:
            if meta.get("request_id") is not None:
                seen.setdefault((meta["request_id"], int(meta["seq"])), text)
    out: dict[str, str] = {}
    for rid, _seq in sorted(seen):
        out[rid] = out.get(rid, "") + seen[(rid, _seq)]
    return out


#: case -> (stub kwargs, env, events, the recv call that kills the node)
CASES = {
    "k1_every1": (dict(max_slots=2, window=1),
                  {"DORA_CHECKPOINT_EVERY": "1"},
                  [(None, _req("ab", "ab", 8)), (None, _req("cd", "cd", 8))], 7),
    "k4_every2_backlog": (dict(max_slots=1, window=4, max_seq=128),
                          {"DORA_CHECKPOINT_EVERY": "2"},
                          [(None, _req("a", "first one", 20)), (None, _req("b", "second", 9)),
                           (None, _req("c", "third", 6, "batch"))], 10),
    "spec_prefix_cache": (dict(max_slots=2, window=1, spec_k=2, cycle=7, max_seq=128,
                               prefix_cache=True),
                          {"DORA_CHECKPOINT_EVERY": "1"},
                          [(None, _req("p", "0123456789abcdef", 40)),
                           (after_first_token("p"), _req("q", "0123456789abcdefXY", 40))], 9),
}


def _uninterrupted(kw, events) -> dict[str, str]:
    """The port's run of ``events`` with no recovery knob set."""
    with pytest.MonkeyPatch.context() as mp:
        for knob in ("DORA_CHECKPOINT_DIR", "DORA_MIGRATE_DIR"):
            mp.delenv(knob, raising=False)
        node = ScriptedNode(events)
        _serve("port", node, _engine("port", **kw))
    return _merge(node)


def _crash(stack, kw, events, crash_at, ckpt, sigterm=False):
    node = CrashNode(events, crash_at, sigterm=sigterm)
    metrics = _stacks()[stack][2](engine="paged")
    if sigterm:
        _serve(stack, node, _engine(stack, **kw), metrics)
    else:
        with pytest.raises(RuntimeError, match="simulated kill"):
            _serve(stack, node, _engine(stack, **kw), metrics)
    assert node.closed
    with open(os.path.join(ckpt, "state.json")) as f:
        return node, metrics, json.load(f)


def _resume(stack, kw, events=()):
    node = ScriptedNode(list(events))
    metrics = _serve(stack, node, _engine(stack, **kw))
    return node, metrics


@pytest.mark.parametrize("case", sorted(CASES))
def test_crash_and_resume_matches_jax(monkeypatch, tmp_path, case):
    """serve() checkpointing at its cadence is killed mid-generation; a
    fresh engine's serve() restores the snapshot and finishes every stream.
    Both stacks send the same chunks and write the same state.json; the
    merged chunks are the uninterrupted run's."""
    kw, env, events, crash_at = CASES[case]
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    runs = {}
    for stack in ("jax", "port"):
        ckpt = str(tmp_path / stack)
        monkeypatch.setenv("DORA_CHECKPOINT_DIR", ckpt)
        node1, m1, state = _crash(stack, kw, events, crash_at, ckpt)
        node2, m2 = _resume(stack, kw)
        runs[stack] = (node1, m1, state, node2, m2)
    (j1, jm1, jstate, j2, jm2), (t1, tm1, tstate, t2, tm2) = runs["jax"], runs["port"]
    assert t1.sent == j1.sent and t2.sent == j2.sent
    assert tstate == jstate
    assert _comparable(tm1.snapshot()) == _comparable(jm1.snapshot())
    assert _comparable(tm2.snapshot()) == _comparable(jm2.snapshot())
    assert tm1.checkpoints >= 2 and tm2.restored_streams == len(tstate["engine"]["slots"]) > 0
    assert sum(not m["done"] for _o, _t, m in t1.sent) > 0
    assert len([m for _o, _t, m in t1.sent if m["done"]]) < len(events)  # cut mid-run
    assert _merge(t1, t2) == _uninterrupted(kw, events)


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_state_json_restores_in_the_other_stack(monkeypatch, tmp_path, writer, reader):
    """A state.json the one stack's serve() wrote (live streams, one mid-
    prefill, one parked) restores in the other's; both end in the same
    merged chunks, the uninterrupted run's."""
    kw, env, events, crash_at = CASES["k4_every2_backlog"]
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    monkeypatch.setenv("DORA_CHECKPOINT_DIR", str(tmp_path))
    node1, _m, state = _crash(writer, kw, events, crash_at, str(tmp_path))
    assert state["backlog"] and state["engine"]["slots"]
    node2, m2 = _resume(reader, kw)
    assert m2.restored_streams == len(state["engine"]["slots"])
    assert _merge(node1, node2) == _uninterrupted(kw, events)


@pytest.mark.parametrize("stack", ["jax", "port"])
def test_replayed_input_is_not_readmitted(monkeypatch, tmp_path, stack):
    """The daemon replays an unacknowledged input after a respawn: a wire
    request_id the restored engine already runs is dropped."""
    monkeypatch.setenv("DORA_CHECKPOINT_DIR", str(tmp_path))
    monkeypatch.setenv("DORA_CHECKPOINT_EVERY", "1")
    kw = dict(max_slots=2, window=1)
    events = [(None, _req("ab", "ab", 8))]
    node1, _m, _state = _crash(stack, kw, events, 5, str(tmp_path))
    node2, m2 = _resume(stack, kw, events)
    assert m2.restored_streams == 1 and m2.requests == 0
    assert _merge(node1, node2) == _uninterrupted(kw, events)


def test_sigterm_checkpoints_and_exits_cleanly_like_jax(monkeypatch, tmp_path):
    """SIGTERM sets the stop flag: the loop writes a checkpoint at its next
    tick and leaves cleanly (closing the node, then the exit snapshot); a
    fresh engine resumes from it. Both stacks alike."""
    monkeypatch.setenv("DORA_CHECKPOINT_EVERY", "0")  # only SIGTERM and exit write
    kw, _env, events, _ = CASES["k1_every1"]
    runs = {}
    for stack in ("jax", "port"):
        ckpt = str(tmp_path / stack)
        monkeypatch.setenv("DORA_CHECKPOINT_DIR", ckpt)
        node1, m1, state = _crash(stack, kw, events, 6, ckpt, sigterm=True)
        node2, m2 = _resume(stack, kw)
        runs[stack] = (node1, m1, state, node2, m2)
    (j1, jm1, jstate, j2, _), (t1, tm1, tstate, t2, tm2) = runs["jax"], runs["port"]
    assert t1.sent == j1.sent and tstate == jstate and t2.sent == j2.sent
    assert tm1.checkpoints == jm1.checkpoints == 2  # sigterm, then exit
    assert t1.calls == 6  # no recv after the signal's tick
    assert tm2.restored_streams == 2
    assert _merge(t1, t2) == _uninterrupted(kw, events)


# ---------------------------------------------------------------------------
# drain and migrate
# ---------------------------------------------------------------------------


def test_migrate_drains_to_a_target_like_jax(monkeypatch, tmp_path):
    """A MIGRATE after the first token drains the live streams (decoding
    and mid-prefill) and the parked backlog into a handoff file; a target
    with DORA_MIGRATE_DIR admits it and finishes every stream under its
    wire id with seqs running on. Both stacks write the same handoff and
    send the same chunks; merged, they are the uninterrupted run's (the
    stub reads no KV, so a migrated decode stream is exact)."""
    kw = dict(max_slots=2, window=2, max_seq=128)
    reqs = [(None, _req("a", "alpha", 12)), (None, _req("b", "beta", 10)),
            (None, _req("c", "x" * 40, 6)), (None, _req("d", "parked", 5))]
    runs = {}
    for stack in ("jax", "port"):
        handoff = str(tmp_path / stack)
        monkeypatch.delenv("DORA_MIGRATE_DIR", raising=False)
        src = ScriptedNode(reqs + [(after_first_token("a"), {
            "type": "MIGRATE", "metadata": {"handoff_dir": handoff}})])
        sm = _serve(stack, src, _engine(stack, **kw))
        (name,) = os.listdir(handoff)
        with open(os.path.join(handoff, name)) as f:
            payload = json.load(f)
        monkeypatch.setenv("DORA_MIGRATE_DIR", handoff)
        target = _engine(stack, **kw)
        dst = StopWhenIdle(target)
        dm = _serve(stack, dst, target)
        assert os.listdir(handoff) == []  # claimed and removed
        runs[stack] = (src, sm, payload, dst, dm)
    (js, jsm, jp, jd, jdm), (ts, tsm, tp, td, tdm) = runs["jax"], runs["port"]
    assert ts.sent == js.sent and tp == jp and td.sent == jd.sent
    assert tsm.migrated_out == jsm.migrated_out == tdm.migrated_in == jdm.migrated_in == 4
    assert len(tp["engine"]["slots"]) == 2 and len(tp["backlog"]) == 2
    assert {m["decode"] for m in tp["engine"]["slots"]} == {True, False}
    assert _merge(ts, td) == _uninterrupted(kw, reqs)
    for rid in ("a", "b", "c", "d"):
        seqs = [m["seq"] for _o, _t, m in ts.sent + td.sent if m.get("request_id") == rid]
        assert seqs == list(range(len(seqs))), rid  # gapless across the hop


def _handoff(tmp_path, stack):
    """Drain a stub with two decoding streams into a handoff file, in
    handle_migrate's format; returns its path."""
    src = _engine(stack, max_slots=2, max_seq=64, page_size=8, chunk=16, window=1)
    src.submit("r0", [5], 10)
    src.submit("r1", [9], 10)
    for _ in range(3):
        src.step()
    state = src.drain_streams()
    keys = [m["request_id"] for m in state["slots"]]
    payload = {"engine": state, "backlog": [], "wire_ids": {k: f"wire-{k}" for k in keys},
               "seqs": {k: 3 for k in keys}, "ctxs": {k: "" for k in keys}}
    os.makedirs(tmp_path, exist_ok=True)
    path = os.path.join(tmp_path, "streams-1-1.json")
    with open(path, "w") as f:
        json.dump(payload, f)
    return path


@pytest.mark.parametrize("stack", ["jax", "port"])
def test_migrate_in_defers_a_handoff_it_cannot_admit(monkeypatch, tmp_path, stack):
    """A target with one slot leaves a two-stream handoff on disk,
    unclaimed, and sends nothing."""
    path = _handoff(tmp_path, stack)
    monkeypatch.setenv("DORA_MIGRATE_DIR", str(tmp_path))
    target = _engine(stack, max_slots=1, max_seq=64, page_size=8, chunk=16, window=1)
    node = StopWhenIdle(target)
    metrics = _serve(stack, node, target)
    assert os.path.exists(path) and not os.path.exists(path + ".claimed")
    assert metrics.migrated_in == 0 and node.sent == []


@pytest.mark.parametrize("stack", ["jax", "port"])
def test_migrate_in_admit_race_fails_the_streams_retriably(monkeypatch, tmp_path, stack):
    """Capacity that goes between the peek and the claim: the admitted part
    is rolled back and every handoff stream closes with a retriable
    "error" under its wire id and its migrated seq."""
    path = _handoff(tmp_path, stack)
    monkeypatch.setenv("DORA_MIGRATE_DIR", str(tmp_path))
    target = _engine(stack, max_slots=2, max_seq=64, page_size=8, chunk=16, window=1)
    admit = target.admit_streams

    def raced(state):
        admit({"slots": state["slots"][:1], "kv_dtype": state.get("kv_dtype", "fp")})
        raise RuntimeError("no free slot for migrated stream")

    target.admit_streams = raced
    node = StopWhenIdle(target)
    metrics = _serve(stack, node, target)
    assert not os.path.exists(path)
    errors = {m["request_id"]: (m["finish"], m["seq"]) for _o, _t, m in node.sent if m["done"]}
    assert errors == {"wire-r0": ("error", 3), "wire-r1": ("error", 3)}
    assert metrics.migrated_in == 0 and metrics.rejected == 2
    assert target.active == 0 and target.free_pages == target.allocator.num_pages - 1


def test_tracer_context_and_release_match_jax():
    """``ServingTracer.context`` serializes a request's context in the JAX
    format (the carrier's trace id, a span of its own) and ``release``
    drops it without an ``s_finish``: what checkpoints and handoffs carry."""
    from dora_tpu import telemetry as jt
    from dora_tpu_torch import telemetry as tt

    class Ring:
        def __init__(self):
            self.rows = []

        def record(self, kind, a, b, c):
            self.rows.append((kind, a, b, c))

    parent = "traceparent:00-0123456789abcdef0123456789abcdef-00f067aa0ba902b7-01;"
    got = []
    for mod in (jt, tt):
        ring = Ring()
        tracer = mod.ServingTracer(flight=ring, tracing=mod.TracingState(True))
        tracer.begin("req-1", parent)
        ctx = tracer.context("req-1")
        tracer.span("s_migrate_out", "req-1", "dir=x", dur_ns=5)
        tracer.release("req-1")
        tracer.finish("req-1", "stop")
        off = mod.ServingTracer(flight=ring, tracing=mod.TracingState(False))
        off.begin("req-2", parent)
        got.append((ctx.split("-")[:2] + [len(ctx)], tracer.context("req-1"),
                    off.context("req-2"), [(k, b) for k, _a, b, _c in ring.rows]))
    assert got[0][0] == got[1][0] == [
        "traceparent:00", "0123456789abcdef0123456789abcdef", len(parent)]
    assert got[1][1:3] == got[0][1:3] == ("", "")
    assert [k for k, _b in got[1][3]] == [k for k, _b in got[0][3]] == ["s_migrate_out",
                                                                      "s_finish"]
    assert got[1][3][1][1] is None and got[0][3][1][1] is None  # released: no context
