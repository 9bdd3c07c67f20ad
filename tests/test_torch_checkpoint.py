"""The port's checkpoint surface (dora_tpu_torch/models/batch_engine.py,
models/checkpoint.py) against dora_tpu's, on the CPU.

The same submits and steps, on the JAX package's stub engine and the port's
(and then on the tiny random Qwen2 of tests/test_torch_paged_engine.py),
give equal ``checkpoint_state`` dicts: slot, request id, counts, page ids,
shared pages, prompt, chunk base, last token and position, adapter by name,
spec history, kv_dtype. Restoring a snapshot (through JSON, as state.json
carries it) resumes every stream where the uninterrupted run goes on, in
both stacks, with the same page ids afterwards; drain / admit moves streams
to a second engine as the JAX engines do. A restore with pools (the port's
own file format) continues the tiny Qwen2's streams token for token as the
JAX engine's uninterrupted run, and the pools are the same tensors after it.
On the CPU the window runner runs eagerly over the same static buffers a
CUDA graph replays, so the restored rows of those buffers are checked here.
Tokens and page ids compare exactly.
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from tests.test_torch_paged_engine import both, tiny_qwen2  # noqa: F401 (fixtures)


def _stubs(**kw):
    """(JAX stub, port stub) built alike."""
    from dora_tpu.models.batch_engine import make_stub_paged_engine as jax_stub
    from dora_tpu_torch.models.batch_engine import make_stub_paged_engine

    return jax_stub(**kw), make_stub_paged_engine(**kw, device="cpu")


def _steps(engine, n: int, out: dict) -> None:
    for _ in range(n):
        for key, token, _done in engine.step():
            out.setdefault(key, []).append(int(token))


def _run_to_done(engine, out: dict, max_steps: int = 400) -> None:
    for _ in range(max_steps):
        if engine.active == 0:
            return
        _steps(engine, 1, out)
    raise AssertionError("engine did not finish")


def _json(state: dict) -> dict:
    return json.loads(json.dumps(state))


def _free_list(engine_or_allocator) -> list[int]:
    return list(getattr(engine_or_allocator, "allocator", engine_or_allocator)._free)


# ---------------------------------------------------------------------------
# PageAllocator.take
# ---------------------------------------------------------------------------


def test_allocator_take_keeps_the_jax_order():
    """All-or-nothing, refusing held and repeated pages; the free list
    keeps the JAX allocator's order, so later grants name the same ids."""
    from dora_tpu.models.batch_engine import PageAllocator as JaxAllocator
    from dora_tpu_torch.models.batch_engine import PageAllocator

    got, want = PageAllocator(12), JaxAllocator(12)
    for a in (got, want):
        first = a.alloc(3)
        a.free(first[1:2])
        assert a.take([9, 4, 7])
        assert not a.take([9, 5])  # 9 is held: nothing is taken
        assert not a.take([6, 6])  # a repeated id
        assert not a.take([0])     # the null page is never free
        assert a.take([])
        a.check_invariants()
    assert _free_list(got) == _free_list(want)
    assert got.in_use == want.in_use == 5 and got.peak_in_use == want.peak_in_use
    assert got.alloc(4) == want.alloc(4)
    assert _free_list(got) == _free_list(want)


# ---------------------------------------------------------------------------
# checkpoint_state / restore_state / drain / admit on the stubs
# ---------------------------------------------------------------------------

#: case -> (stub kwargs, [(request id, prompt, max_new)], steps before the
#: snapshot); every case snapshots with a stream still mid-prefill
STUB_CASES = {
    "k1": (dict(max_slots=3, window=1),
           [("r0", [5], 10), ("r1", [9, 4, 4], 12), ("r2", list(range(1, 40)), 6)], 1),
    "k4": (dict(max_slots=3, window=4),
           [("r0", [5, 6], 14), ("r1", [9], 20), ("r2", list(range(3, 45)), 9)], 1),
    "spec": (dict(max_slots=3, window=2, spec_k=3, cycle=5),
             [("r0", [1, 2, 3, 4], 16), ("r1", [2, 3], 18), ("r2", list(range(2, 38)), 5)], 1),
    "prefix_cache": (dict(max_slots=3, window=2, prefix_cache=True),
                     [("r0", list(range(1, 17)), 8), ("r1", list(range(1, 17)) + [40, 41], 8),
                      ("r2", list(range(50, 90)), 6)], 1),
}


def _submit_all(engine, reqs, gap_steps: int, out: dict) -> None:
    """Submit the requests one step apart (r2, the long prompt, last)."""
    for rid, prompt, max_new in reqs:
        engine.submit(rid, prompt, max_new)
        _steps(engine, gap_steps, out)


@pytest.mark.parametrize("case", sorted(STUB_CASES))
def test_checkpoint_state_matches_jax_on_the_stub(case):
    kw, reqs, pre = STUB_CASES[case]
    jax_e, port = _stubs(**kw)
    outs = []
    for e in (jax_e, port):
        out: dict = {}
        _submit_all(e, reqs, 1, out)
        _steps(e, pre, out)
        outs.append(out)
    assert outs[0] == outs[1]
    want, got = _json(jax_e.checkpoint_state()), _json(port.checkpoint_state())
    assert got == want
    assert any(not m["decode"] for m in got["slots"]), "a stream is mid-prefill"
    assert any(m["decode"] for m in got["slots"]), "a stream decodes"
    if case == "prefix_cache":
        assert any(m["shared"] for m in got["slots"])
    if case == "spec":
        assert all(m["history"] for m in got["slots"] if m["decode"])


@pytest.mark.parametrize("case", sorted(STUB_CASES))
def test_restore_resumes_like_jax_on_the_stub(case):
    """A snapshot restored on fresh engines (pinned slots and pages) goes
    on as the uninterrupted run; the port's restored engine equals the
    JAX one's (tokens, later snapshots, free lists)."""
    kw, reqs, pre = STUB_CASES[case]
    ref_e, src = _stubs(**kw)
    ref: dict = {}
    _submit_all(ref_e, reqs, 1, ref)
    _run_to_done(ref_e, ref)
    before: dict = {}
    _submit_all(src, reqs, 1, before)
    _steps(src, pre, before)
    snap = _json(src.checkpoint_state())

    jax_e, port = _stubs(**kw)
    assert port.restore_state(snap) == jax_e.restore_state(_json(snap))
    port.check_invariants()
    assert _free_list(port) == _free_list(jax_e)
    after_port: dict = {}
    after_jax: dict = {}
    _steps(port, 1, after_port)
    _steps(jax_e, 1, after_jax)
    assert _json(port.checkpoint_state()) == _json(jax_e.checkpoint_state())
    _run_to_done(port, after_port)
    _run_to_done(jax_e, after_jax)
    assert after_port == after_jax
    for rid, _p, _n in reqs:
        assert before.get(rid, []) + after_port.get(rid, []) == ref[rid], rid
    port.check_invariants()
    assert port.free_pages == port.allocator.num_pages - 1 - (
        port.prefix_cache.size if port.prefix_cache is not None else 0)


@pytest.mark.parametrize("spec_k", [0, 3])
def test_drain_and_admit_match_jax_on_the_stub(spec_k):
    """drain_streams frees every slot and page and empties the prefill
    queue; admit_streams on a second engine (fresh slots and pages)
    continues every stream; both stacks agree on the drained state, the
    grants and the tokens."""
    kw = dict(max_slots=3, window=2, spec_k=spec_k, cycle=6)
    reqs = [("r0", [1, 2, 3], 14), ("r1", [4, 5], 12), ("r2", list(range(1, 40)), 5)]
    ref_e, _ = _stubs(**kw)
    ref: dict = {}
    _submit_all(ref_e, reqs, 1, ref)
    _run_to_done(ref_e, ref)
    states, tokens, targets = [], [], []
    for src, dst in zip(_stubs(**kw), _stubs(**dict(kw, max_slots=4, num_pages=40))):
        before: dict = {}
        _submit_all(src, reqs, 1, before)
        state = _json(src.drain_streams())
        assert src.active == 0 and src.prefilling == 0
        assert src.free_pages == src.allocator.num_pages - 1
        dst.submit("local", [7, 7], 3)  # the target already serves a stream
        assert dst.admit_streams(state) == [m["request_id"] for m in sorted(
            state["slots"], key=lambda m: not m["decode"])]
        after: dict = {}
        _run_to_done(dst, after)
        states.append(state)
        tokens.append((before, after))
        targets.append(dst)
    assert states[0] == states[1]
    assert tokens[0] == tokens[1]
    assert _free_list(targets[0]) == _free_list(targets[1])
    before, after = tokens[1]
    for rid, _p, _n in reqs:
        assert before.get(rid, []) + after.get(rid, []) == ref[rid], rid


def test_specless_snapshot_restores_on_a_spec_engine_like_jax():
    """A spec-off snapshot carries no history: a spec-on engine seeds it
    with the last token, resumes exactly, and its later snapshot (history
    included) is the JAX engine's."""
    reqs = [("r0", [5], 16), ("r1", [6, 1], 16)]
    src_j, src_p = _stubs(max_slots=2, window=1, cycle=4)
    for src in (src_j, src_p):
        _submit_all(src, reqs, 1, {})
        _steps(src, 3, {})
    snap = _json(src_p.checkpoint_state())
    assert snap == _json(src_j.checkpoint_state())
    assert all("history" not in m for m in snap["slots"])
    jax_e, port = _stubs(max_slots=2, window=2, spec_k=3, cycle=4)
    port.restore_state(snap)
    jax_e.restore_state(_json(snap))
    assert port._hist == jax_e._hist
    for e in (jax_e, port):
        _steps(e, 1, {})
    assert _json(port.checkpoint_state()) == _json(jax_e.checkpoint_state())
    a, b = {}, {}
    _run_to_done(port, a)
    _run_to_done(jax_e, b)
    assert a == b


def test_adapter_restores_by_name_and_kv_dtype_must_match():
    """The snapshot names the tenant; the restore re-acquires it resident
    by name (another resident slot than the source's here) and the stream
    goes on with its adapter; a kv_dtype mismatch, or an adapter on an
    engine without a pool, raises as in JAX."""
    kw = dict(max_slots=3, window=2, lora_max_resident=2)
    reqs = [("t", [3, 4], 10, "alpha"), ("b", [5], 10, None)]
    ref_e, src = _stubs(**kw)
    ref: dict = {}
    before: dict = {}
    for e, out in ((ref_e, ref), (src, before)):
        e.submit("warm", [1], 1, adapter="beta")  # resident slot 2: alpha gets 1
        for rid, prompt, max_new, ad in reqs:
            e.submit(rid, prompt, max_new, adapter=ad)
        _steps(e, 2, out)
    _run_to_done(ref_e, ref)
    snap = _json(src.checkpoint_state())
    assert [m.get("adapter") for m in snap["slots"] if m["request_id"] == "t"] == ["alpha"]
    jax_e, port = _stubs(**kw)
    port.restore_state(snap)
    jax_e.restore_state(_json(snap))
    assert src.lora.slot_of("alpha") == 1
    assert port.lora.slot_of("alpha") == jax_e.lora.slot_of("alpha") == 2
    after: dict = {}
    _run_to_done(port, after)
    for rid in ("t", "b"):
        assert before.get(rid, []) + after.get(rid, []) == ref[rid], rid
    for e in _stubs(max_slots=2):
        with pytest.raises(ValueError, match="kv_dtype 'int8' does not match"):
            e.restore_state({**snap, "kv_dtype": "int8"})
        with pytest.raises(RuntimeError, match="no adapter pool"):
            e.restore_state(snap)


def test_restore_rewrites_the_rows_of_the_static_window_buffers():
    """The window runner reads static buffers (a CUDA graph replays over
    them on the card; on the CPU it runs eagerly over the same ones).
    Streams restored into an engine that is serving, whose window has run
    since its last membership change (no rewrite pending) and whose free
    row holds a finished stream's stale state, get their rows rewritten
    before the next window: block table, mask, counts, token and position,
    in the same tensors. The restored streams and the live one go on as
    their uninterrupted runs."""
    reqs = [("r0", [5, 1], 20), ("r1", [9], 20)]
    ref_e, src = _stubs(max_slots=2, window=4, max_seq=64)
    ref: dict = {}
    _submit_all(ref_e, reqs, 0, ref)
    _run_to_done(ref_e, ref)
    before: dict = {}
    _submit_all(src, reqs, 0, before)
    _steps(src, 2, before)
    state = _json(src.drain_streams())
    _, alone = _stubs(max_slots=3, window=4, max_seq=64)
    keep: dict = {}
    alone.submit("keep", [30, 31], 40)
    _run_to_done(alone, keep)
    _, port = _stubs(max_slots=3, window=4, max_seq=64)
    port.submit("keep", [30, 31], 40)
    port.submit("old", [2, 3], 3)  # ends in its first window: row 1 goes stale
    live: dict = {}
    _steps(port, 3, live)
    assert len(live["old"]) == 3 and port.slots[1] is None
    assert not port._members_dirty and not port._bt_dirty  # no rewrite pending
    stale = port._bt_dec.clone()
    binding = [port.tokens, port.positions, port._bt_dec, port._mask, port._emitted_dev,
               port._maxnew_dev]
    assert port.admit_streams(state) == ["r0", "r1"]
    after: dict = {}
    _steps(port, 1, after)
    assert all(a is b for a, b in zip([port.tokens, port.positions, port._bt_dec, port._mask,
                                       port._emitted_dev, port._maxnew_dev], binding))
    for b, rid in ((1, "r0"), (2, "r1")):
        s = port.slots[b]
        assert s.request_id == rid
        assert port._bt_dec[b, : len(s.pages)].tolist() == s.pages
        assert bool(port._mask[b]) and int(port._maxnew_dev[b]) == 20
    assert not torch.equal(port._bt_dec[1], stale[1])
    assert port.graph_captures == 1  # the same runner, bound once
    _run_to_done(port, after)
    assert live["keep"] + after["keep"] == keep["keep"]
    for rid, _p, _n in reqs:
        assert before[rid] + after[rid] == ref[rid], rid
    port.check_invariants()


# ---------------------------------------------------------------------------
# models/checkpoint.py
# ---------------------------------------------------------------------------


def test_checkpoint_restore_copies_in_place_and_checks_the_layout(tmp_path):
    from dora_tpu_torch.models import checkpoint

    rng = np.random.default_rng(3)
    pools = {"0": {"k": torch.from_numpy(rng.standard_normal((3, 2, 4)).astype(np.float32)),
                   "ks": torch.zeros((3, 2), dtype=torch.bfloat16)},
             "1": {"k": torch.arange(6, dtype=torch.int8).reshape(2, 3)}}
    path = tmp_path / "pools"
    checkpoint.save(path, pools)
    assert not (tmp_path / "pools.tmp").exists()
    like = {"0": {"k": torch.zeros((3, 2, 4)), "ks": torch.ones((3, 2), dtype=torch.bfloat16)},
            "1": {"k": torch.zeros((2, 3), dtype=torch.int8)}}
    ptrs = [like["0"]["k"].data_ptr(), like["0"]["ks"].data_ptr(), like["1"]["k"].data_ptr()]
    assert checkpoint.restore(path, like) is like
    assert [like["0"]["k"].data_ptr(), like["0"]["ks"].data_ptr(),
            like["1"]["k"].data_ptr()] == ptrs
    for name in ("k", "ks"):
        assert torch.equal(like["0"][name], pools["0"][name])
    assert torch.equal(like["1"]["k"], pools["1"]["k"])
    keep = like["0"]["k"].clone()
    with pytest.raises(ValueError, match="0/k is torch.float32 .3, 2, 4., expected"):
        checkpoint.restore(path, {**like, "0": {**like["0"], "k": torch.zeros((3, 2, 5))}})
    with pytest.raises(ValueError, match="1/k is torch.int8"):
        checkpoint.restore(path, {**like, "1": {"k": torch.zeros((2, 3))}})
    with pytest.raises(ValueError, match="keys"):
        checkpoint.restore(path, {"0": like["0"]})
    assert torch.equal(like["0"]["k"], keep)  # a refused restore writes nothing


# ---------------------------------------------------------------------------
# the tiny random Qwen2
# ---------------------------------------------------------------------------


def _qwen2_engines(both, **kw):  # noqa: F811
    from dora_tpu.models.hf import qwen2 as jq
    from dora_tpu_torch.models.hf import qwen2 as tq

    cfg, qparams, tcfg, tparams = both
    kw = dict(max_slots=3, page_size=8, chunk=8, window=2, prefix_cache=True, **kw)
    return jq.make_paged_engine(qparams, cfg, **kw), tq.make_paged_engine(
        tparams, tcfg, device="cpu", **kw)


def _qwen2_requests(vocab):
    """A shared 24-token prefix (three pages) behind two prompts, and a
    third prompt of its own that is still prefilling at the snapshot."""
    rng = np.random.default_rng(11)
    prefix = rng.integers(0, vocab, size=24).tolist()
    return [("a", prefix + rng.integers(0, vocab, size=3).tolist(), 20),
            ("b", prefix + rng.integers(0, vocab, size=5).tolist(), 20),
            ("c", rng.integers(0, vocab, size=30).tolist(), 8)]


def _qwen2_drive(engine, reqs, out, snap_after: int) -> None:
    """``a`` runs until the prefix is cached, then ``b`` and ``c`` join;
    ``snap_after`` steps later the caller snapshots."""
    engine.submit(*reqs[0])
    _steps(engine, 5, out)
    engine.submit(*reqs[1])
    engine.submit(*reqs[2])
    _steps(engine, snap_after, out)


def test_checkpoint_and_restore_with_pools_on_tiny_qwen2(both, tmp_path):  # noqa: F811
    """With prefix-shared pages live: the port's snapshot equals the JAX
    engine's; restored with its pools (``save_pools`` / ``restore_pools``)
    on a fresh engine, pinned, every stream goes on token for token as the
    JAX engine's uninterrupted run, and the pools are the same tensors."""
    cfg = both[0]
    reqs = _qwen2_requests(cfg.vocab)
    jax_e, port = _qwen2_engines(both)
    want: dict = {}
    before: dict = {}
    _qwen2_drive(jax_e, reqs, want, 4)
    _qwen2_drive(port, reqs, before, 4)
    assert before == want
    snap = _json(port.checkpoint_state())
    assert snap == _json(jax_e.checkpoint_state())
    metas = {m["request_id"]: m for m in snap["slots"]}
    assert metas["a"]["decode"] and metas["b"]["decode"] and not metas["c"]["decode"]
    assert metas["b"]["shared"] == 3
    assert set(metas["a"]["pages"]) & set(metas["b"]["pages"])
    port.save_pools(tmp_path / "pools")
    _run_to_done(jax_e, want)

    _, fresh = _qwen2_engines(both)
    ptrs = {(i, n): t.data_ptr() for i, lp in fresh.pools.items() for n, t in lp.items()}
    pools = fresh.pools
    fresh.restore_pools(tmp_path / "pools")
    assert fresh.pools is pools
    assert {(i, n): t.data_ptr() for i, lp in fresh.pools.items()
            for n, t in lp.items()} == ptrs
    for i, lp in port.pools.items():
        for n, t in lp.items():
            assert torch.equal(fresh.pools[i][n], t), (i, n)
    assert fresh.restore_state(snap) == ["a", "b", "c"]
    for p in set(metas["a"]["pages"]) & set(metas["b"]["pages"]):
        assert fresh.allocator.refcount(p) == 2
    fresh.check_invariants()
    after: dict = {}
    _run_to_done(fresh, after)
    for rid, _p, _n in reqs:
        assert before.get(rid, []) + after.get(rid, []) == want[rid], rid
    fresh.check_invariants()


def test_migrated_streams_on_tiny_qwen2_restart_their_prefill_like_jax(both):  # noqa: F811
    """drain / admit on the tiny Qwen2 (no pools travel): both stacks drain
    the same state and re-grant the same pages; the mid-prefill stream,
    re-prefilled from scratch, equals its uninterrupted run in both."""
    cfg = both[0]
    reqs = _qwen2_requests(cfg.vocab)
    ref_e, _ = _qwen2_engines(both)
    ref: dict = {}
    _qwen2_drive(ref_e, reqs, ref, 2)
    _run_to_done(ref_e, ref)
    runs = []
    for src, dst in zip(_qwen2_engines(both), _qwen2_engines(both)):
        before: dict = {}
        _qwen2_drive(src, reqs, before, 2)
        state = _json(src.drain_streams())
        admitted = dst.admit_streams(state)
        grants = [list(s.pages) if s is not None else None for s in dst.slots]
        after: dict = {}
        _run_to_done(dst, after)
        runs.append((state, admitted, grants, before, after))
    assert runs[0][:3] == runs[1][:3]
    state, _, _, before, after = runs[1]
    assert runs[0][4]["c"] == after["c"]
    prefilling = [m["request_id"] for m in state["slots"] if not m["decode"]]
    assert prefilling == ["c"]
    assert before.get("c", []) + after["c"] == ref["c"]
