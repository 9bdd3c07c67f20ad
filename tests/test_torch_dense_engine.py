"""The port's dense continuous-batching engine against dora_tpu's, on the CPU.

On the tiny random ``transformers`` Qwen2, over ``params_from_jax`` of the
JAX package's quantized weights (both in f32, the port on its plain
versions): ``prefill_padded`` gives the JAX package's first token and
caches (1e-5 of their largest magnitude: f32 sums in another order);
streams that join mid-flight emit exactly the tokens of serial
``generate`` and of the JAX package's ``BatchEngine`` on the same schedule
(the property of tests/test_batch_engine.py); and ``make_engine`` with
``DORA_PAGED_KV=0`` serves through ``serve_prompts`` with each first token
emitted at submit.
"""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_paged_engine import tiny_qwen2  # noqa: F401 (fixture)


@pytest.fixture(scope="module")
def both(tiny_qwen2):  # noqa: F811
    from dora_tpu.models.hf import qwen2 as jq
    from dora_tpu_torch.models.hf import qwen2 as tq

    cfg, params = jq.load(tiny_qwen2, max_seq=64)
    os.environ["DORA_INT8_DECODE"] = "1"
    try:
        qparams = jq.quantize_decode(params, cfg)
    finally:
        os.environ.pop("DORA_INT8_DECODE", None)
    tcfg, _ = tq.load(tiny_qwen2, max_seq=64, device="cpu")
    return cfg, qparams, tcfg, tq.params_from_jax(qparams, device="cpu")


def test_prefill_padded_matches_jax(both):
    """A 12-token prompt padded to its 16-row bucket: the first token, the
    position and every cache row (pad rows included)."""
    from dora_tpu.models.hf import qwen2 as jq
    from dora_tpu_torch.models.hf import qwen2 as tq

    cfg, qparams, tcfg, tparams = both
    rng = np.random.default_rng(1)
    ids = rng.integers(0, cfg.vocab, size=12).tolist() + [0] * 4
    jf, jc, jpos = jq.prefill_padded(qparams, cfg, jnp.asarray([ids], jnp.int32),
                                     jnp.asarray(12, jnp.int32))
    tf, tc, tpos = tq.prefill_padded(tparams, tcfg, torch.tensor([ids], dtype=torch.int32), 12)
    assert tf.dtype == torch.int32 and tf.tolist() == np.asarray(jf).tolist()
    assert tpos == int(jpos) == 12
    assert set(tc) == set(jc)
    for layer in jc:
        for key in ("k", "v"):
            want = np.asarray(jc[layer][key])
            got = tc[layer][key].numpy()
            assert got.shape == want.shape == (1, cfg.kv_heads, cfg.max_seq, cfg.head_dim)
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def _drive(engine, prompts, max_new):
    """tests/test_batch_engine.py's schedule: r1 joins while r0 decodes, r2
    while both do."""
    streams = {"r0": [engine.submit("r0", prompts[0], max_new)[0]]}

    def drain(events):
        for rid, token, _done in events:
            streams[rid].append(token)

    drain(engine.step())
    drain(engine.step())
    streams["r1"] = [engine.submit("r1", prompts[1], max_new)[0]]
    drain(engine.step())
    streams["r2"] = [engine.submit("r2", prompts[2], max_new)[0]]
    for _ in range(max_new + 2):
        drain(engine.step())
    assert engine.active == 0
    return streams


def test_mid_flight_joins_match_serial_and_jax(both):
    from dora_tpu.models.hf import qwen2 as jq
    from dora_tpu_torch.models.hf import qwen2 as tq

    cfg, qparams, tcfg, tparams = both
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, size=n).tolist() for n in (3, 7, 12)]
    max_new = 10
    serial = [tq.generate(tparams, tcfg, torch.tensor([p]), max_new)[0].tolist()
              for p in prompts]
    port = tq.make_batch_engine(tparams, tcfg, max_slots=3, device="cpu")
    got = _drive(port, prompts, max_new)
    assert [got[f"r{i}"] for i in range(3)] == serial
    want = _drive(jq.make_batch_engine(qparams, cfg, max_slots=3), prompts, max_new)
    assert got == want
    assert port.free_slots == 3 and port.emit_lag_s == {}
    # one prefill and one fetch per submit, one pass and one fetch per step
    # with a stream in it: 12 (r2 joins before pass 4 and needs 9 more)
    assert port.dispatches == port.fetches == 3 + 12


def test_admission_eos_and_slot_reuse(both):
    from dora_tpu_torch.models.hf import qwen2 as tq

    _, _, tcfg, tparams = both
    prompt = [9, 8, 7]
    ref = tq.generate(tparams, tcfg, torch.tensor([prompt]), 8)[0].tolist()
    engine = tq.make_batch_engine(tparams, tcfg, max_slots=2, eos=ref[3], device="cpu")
    assert not engine.can_admit(60, 10)  # exceeds max_seq
    stream = [engine.submit("x", prompt, 8)[0]]
    engine.submit("y", [4, 5], 3)
    assert engine.free_slots == 0
    with pytest.raises(RuntimeError, match="cannot admit"):
        engine.submit("z", [6], 3)
    while engine.active:
        for rid, token, _done in engine.step():
            if rid == "x":
                stream.append(token)
    assert stream == ref[:4]  # stops AT the eos token
    assert engine.free_slots == 2
    # a freed slot admits again; max_new == 1 finishes at submit
    assert engine.submit("w", prompt, 1) == (ref[0], True)
    assert engine.active == 0


def test_make_engine_dense_serves_through_serve_prompts(both, monkeypatch):
    """DORA_PAGED_KV=0: a BatchEngine of DORA_BATCH_SLOTS slots (default 4);
    five requests wait for slots, each first token is emitted by its submit,
    and every stream equals serial generate."""
    from dora_tpu_torch.models.batch_engine import BatchEngine
    from dora_tpu_torch.models.hf import qwen2 as tq
    from dora_tpu_torch.nodehub.llm_server import make_engine, serve_prompts

    _, _, tcfg, tparams = both
    for key in ("DORA_BATCH_SLOTS", "DORA_FUSED_DECODE"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("DORA_PAGED_KV", "0")
    engine = make_engine(tparams, tcfg, device="cpu")
    assert isinstance(engine, BatchEngine) and engine.max_slots == 4
    monkeypatch.setenv("DORA_BATCH_SLOTS", "2")
    engine = make_engine(tparams, tcfg, device="cpu")
    assert engine.max_slots == 2

    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, tcfg.vocab, size=n).tolist() for n in (4, 9, 2, 15, 6)]
    seen = []  # request index of every emission, in order
    submits = []  # (request id, emissions before its submit)
    inner = engine.submit

    def watched(rid, ids, n):
        submits.append((rid, len(seen)))
        return inner(rid, ids, n)

    engine.submit = watched
    out, ttft = serve_prompts(engine, prompts, 6, on_token=lambda i, t, d: seen.append(i))
    assert sorted(ttft) == list(range(5))
    for i, p in enumerate(prompts):
        assert out[i] == tq.generate(tparams, tcfg, torch.tensor([p]), 6)[0].tolist()
    # every request's first token is the emission right after its submit
    assert [rid for rid, _ in submits] == [str(i) for i in range(5)]
    assert all(seen[n] == int(rid) for rid, n in submits)
    assert max(n for _, n in submits) > 0  # later requests waited for a slot
