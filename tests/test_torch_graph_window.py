"""The window runner (models/vlm.GraphedWindow) and the engines' static
buffers, against dora_tpu's engines, on the CPU.

On the card each decode window and the dense step is one CUDA-graph replay
over the engine's buffers; on the CPU the same runner runs the body eagerly
through the same buffers and the same identity checks, so the engine-side
discipline is tested here: carried vectors are written in place and never
rebound, and a window continues from the last one's carry. On the tiny
random ``transformers`` Qwen2 over ``params_from_jax`` of the JAX
package's quantized weights (both f32, the port on its plain versions):

* staggered admissions at K 8 and 1, speculation off and spec_k 4, fp and
  int8 KV pages, give exactly the JAX paged engine's tokens
  (tests/test_paged_engine.py's schedule; speculation never changes them);
* LoRA with the tenants' adapters loaded into the stack after the first
  window: the JAX engine's tokens on the same schedule;
* rebinding any carried buffer, or a pool, raises the identity error;
  ``graphs=True`` on the CPU raises;
* the counterpart of the reference's compile guard
  (tests/test_paged_engine.py::test_steady_state_adds_zero_compiles...):
  one binding per (K, spec_k) key after warmup, over five new prompt
  lengths and a ``set_window`` round trip;
* the dense engine's step: the JAX ``BatchEngine``'s tokens.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tests.test_torch_lora import lora_qwen2  # noqa: F401 (fixture)
from tests.test_torch_paged_engine import both, tiny_qwen2  # noqa: F401 (fixtures)

#: the carried buffers of every window, by engine attribute
_CARRIED = ("tokens", "positions", "_bt_dec", "_mask", "_emitted_dev", "_maxnew_dev")
_MAX_NEW = 10


def _drain(streams: dict, events) -> None:
    for rid, token, _done in events:
        streams[rid].append(token)


def _staggered(engine, prompts):
    """r0 alone for three steps, r1 and r2 together, then a 37-token prompt
    (five 8-token chunks) while the others decode, then r4."""
    streams = {f"r{i}": [] for i in range(len(prompts))}
    engine.submit("r0", prompts[0], _MAX_NEW)
    for _ in range(3):
        _drain(streams, engine.step())
    engine.submit("r1", prompts[1], _MAX_NEW)
    engine.submit("r2", prompts[2], _MAX_NEW)
    _drain(streams, engine.step())
    engine.submit("r3", prompts[3], _MAX_NEW)
    _drain(streams, engine.step())
    engine.submit("r4", prompts[4], _MAX_NEW)
    for _ in range(300):
        if not engine.active:
            break
        _drain(streams, engine.step())
    assert engine.active == 0
    return streams


def _prompts(vocab):
    rng = np.random.default_rng(5)
    return [rng.integers(0, vocab, size=n).tolist() for n in (3, 7, 12, 37, 5)]


@pytest.fixture(scope="module")
def jax_streams(both):  # noqa: F811
    """The JAX paged engine's streams on the staggered schedule, fp and int8
    KV pages (tokens are the same at every K and spec_k)."""
    from dora_tpu.models.hf import qwen2 as jq

    cfg, qparams, _, _ = both
    return {
        kv_int8: _staggered(jq.make_paged_engine(qparams, cfg, max_slots=5, page_size=8,
                                                 chunk=8, window=8, kv_int8=kv_int8),
                            _prompts(cfg.vocab))
        for kv_int8 in (False, True)
    }


@pytest.mark.parametrize("kv_int8", (False, True), ids=("fp", "int8kv"))
@pytest.mark.parametrize("spec_k", (0, 4))
@pytest.mark.parametrize("window", (8, 1))
def test_runner_buffers_match_jax_across_staggered_admissions(both, jax_streams,  # noqa: F811
                                                              window, spec_k, kv_int8):
    from dora_tpu_torch.models import vlm
    from dora_tpu_torch.models.hf import qwen2 as tq

    _, _, tcfg, tparams = both
    engine = tq.make_paged_engine(tparams, tcfg, max_slots=5, page_size=8, chunk=8,
                                  window=window, spec_k=spec_k, kv_int8=kv_int8,
                                  device="cpu")
    assert not engine.graphs and isinstance(engine.window_step, vlm.GraphedWindow)
    carried = [getattr(engine, n) for n in _CARRIED]
    if spec_k:
        carried += [engine._hist_dev, engine._histlen_dev]
    pools = engine.pools
    got = _staggered(engine, _prompts(tcfg.vocab))
    assert got == jax_streams[kv_int8]
    assert all(len(s) == _MAX_NEW for s in got.values())
    # never rebound, and the runner is bound to exactly these buffers
    assert [getattr(engine, n) for n in _CARRIED] == carried[: len(_CARRIED)]
    runner = engine.window_step
    assert runner._args[0] is engine.tokens and runner._args[2] is engine.positions
    assert all(a is b for a, b in zip(vlm._leaves(engine.pools), vlm._leaves(pools)))
    assert engine.graph_captures == 1 and runner.captures == 1 and runner.replays == 0
    engine.check_invariants()


@pytest.fixture(scope="module")
def jax_tenant_streams(lora_qwen2):  # noqa: F811
    from dora_tpu.models.hf import qwen2 as jq

    cfg, qparams, _, _, lora_dir = lora_qwen2
    return _tenants_late(jq.make_paged_engine(qparams, cfg, max_slots=4, page_size=8,
                                              chunk=8, window=8, lora_dir=lora_dir))


def _tenants_late(engine):
    """A base stream decodes a window before the tenants arrive, so their
    adapters load into a stack the window has already read."""
    streams = {"base": [], "ta": [], "tb": []}
    engine.submit("base", [9, 4], 8)
    _drain(streams, engine.step())  # the first chunk
    _drain(streams, engine.step())  # the first window
    assert engine.lora.loads == 0
    engine.submit("ta", [3, 5, 7], 8, adapter="ta")
    engine.submit("tb", [11, 2], 8, adapter="tb")
    assert engine.lora.loads == 2
    for _ in range(100):
        if not engine.active:
            break
        _drain(streams, engine.step())
    return streams


@pytest.mark.parametrize("spec_k", (0, 4))
def test_runner_reads_adapters_loaded_after_the_first_window(lora_qwen2,  # noqa: F811
                                                             jax_tenant_streams, spec_k):
    from dora_tpu_torch.models.hf import qwen2 as tq

    _, _, tcfg, tparams, lora_dir = lora_qwen2
    engine = tq.make_paged_engine(tparams, tcfg, max_slots=4, page_size=8, chunk=8,
                                  window=8, spec_k=spec_k, lora_dir=lora_dir, device="cpu")
    stack = engine.lora.state()
    adapters = engine._adapter_dev
    got = _tenants_late(engine)
    assert got == jax_tenant_streams
    assert engine.lora.state() is stack and engine._adapter_dev is adapters
    assert engine.window_step._args[-1] is stack
    assert engine.graph_captures == 1


def _bound_engine(tparams, tcfg, **kw):
    """A port engine whose window runner has bound its buffers, with a
    stream still decoding."""
    from dora_tpu_torch.models.hf import qwen2 as tq

    engine = tq.make_paged_engine(tparams, tcfg, max_slots=2, page_size=8, chunk=8,
                                  window=2, device="cpu", **kw)
    engine.submit("r", [3, 1, 4], 12)
    engine.step()
    engine.step()
    assert engine.graph_captures == 1 and engine.active
    return engine


@pytest.mark.parametrize("name", _CARRIED + ("_hist_dev", "_histlen_dev", "pools"))
def test_rebinding_a_carried_buffer_raises(both, name):  # noqa: F811
    _, _, tcfg, tparams = both
    engine = _bound_engine(tparams, tcfg, spec_k=2)
    if name == "pools":
        engine.pools = {**engine.pools, "0": {**engine.pools["0"],
                                              "k": engine.pools["0"]["k"].clone()}}
    else:
        setattr(engine, name, getattr(engine, name).clone())
    with pytest.raises(ValueError, match="static buffer"):
        engine.step()


def test_rebinding_the_adapter_vector_raises(lora_qwen2):  # noqa: F811
    _, _, tcfg, tparams, lora_dir = lora_qwen2
    engine = _bound_engine(tparams, tcfg, lora_dir=lora_dir)
    engine._adapter_dev = engine._adapter_dev.clone()
    with pytest.raises(ValueError, match="argument 7 is not the static buffer"):
        engine.step()


def test_runner_continues_its_carry_and_refuses_fresh_pools():
    """The body's carried results go back into its own arguments, so the
    next call continues from them; a pool returned out of place raises."""
    from dora_tpu_torch.models.vlm import GraphedWindow

    def body(count, pools, step):
        pools["0"]["k"].add_(step)
        return count * 10, count + step, pools

    count, step = torch.tensor([1, 2]), torch.tensor([1, 1])
    pools = {"0": {"k": torch.zeros(2)}}
    run = GraphedWindow(body, carry=(0, 1), graph=False)
    out, c, p = run(count, pools, step)
    assert out.tolist() == [10, 20] and c is count and p is pools
    out, *_ = run(count, pools, step)
    assert out.tolist() == [20, 30] and count.tolist() == [3, 4]
    assert pools["0"]["k"].tolist() == [2.0, 2.0] and run.captures == 1
    with pytest.raises(ValueError, match="argument 2 is not the static buffer"):
        run(count, pools, step.clone())
    fresh = GraphedWindow(lambda c, p: (c, c, {"0": {"k": p["0"]["k"] + 1}}),
                          carry=(0, 1), graph=False)
    with pytest.raises(RuntimeError, match="in place"):
        fresh(count, pools)


@pytest.mark.parametrize("factory", ("paged", "dense", "make_engine", "make_engine_dense"))
def test_graphs_true_on_the_cpu_raises(both, factory, monkeypatch):  # noqa: F811
    from dora_tpu_torch.models.hf import qwen2 as tq
    from dora_tpu_torch.models.vlm import use_graphs
    from dora_tpu_torch.nodehub.llm_server import make_engine

    _, _, tcfg, tparams = both
    build = {
        "paged": lambda: tq.make_paged_engine(tparams, tcfg, max_slots=2, page_size=8,
                                              chunk=8, device="cpu", graphs=True),
        "dense": lambda: tq.make_batch_engine(tparams, tcfg, max_slots=2, device="cpu",
                                              graphs=True),
        "make_engine": lambda: make_engine(tparams, tcfg, device="cpu", graphs=True),
        "make_engine_dense": lambda: make_engine(tparams, tcfg, device="cpu", graphs=True),
    }[factory]
    if factory == "make_engine_dense":
        monkeypatch.setenv("DORA_PAGED_KV", "0")
    with pytest.raises(ValueError, match="graphs=True needs a CUDA device"):
        build()
    assert use_graphs(None, "cpu") is False and use_graphs(False, "cpu") is False


def test_steady_state_binds_one_runner_per_window_key(both):  # noqa: F811
    """After warmup at K 8 and K 1 (speculation off and on), five new prompt
    lengths and a set_window round trip back to used keys bind nothing new,
    and the factory builds each (K, spec_k) window once."""
    from dora_tpu_torch.models.hf import qwen2 as tq

    _, _, tcfg, tparams = both
    engine = tq.make_paged_engine(tparams, tcfg, max_slots=4, page_size=8, chunk=16,
                                  window=8, spec_k=4, device="cpu")
    built = []
    inner = engine._window_factory

    def factory(k, sk):
        built.append((k, sk))
        return inner(k, sk)

    engine._window_factory = factory
    rng = np.random.default_rng(7)

    def run(lengths) -> None:
        streams: dict[str, list[int]] = {}
        for i, n in enumerate(lengths):
            rid = f"w{n}-{i}"
            streams[rid] = []
            while not engine.can_admit(n, 6):
                _drain(streams, engine.step())
            engine.submit(rid, rng.integers(0, tcfg.vocab, size=n).tolist(), 6)
            _drain(streams, engine.step())
        for _ in range(200):
            if not engine.active:
                return
            _drain(streams, engine.step())

    for k, spec_on in ((8, True), (1, True), (8, False), (1, False)):
        engine.set_window(k, spec_on=spec_on)
        run((3, 12, 20))  # warmup: single- and multi-chunk
    warm = engine.graph_captures
    assert warm == 4 and sorted(built) == [(1, 0), (1, 4), (8, 0)]
    run((5, 9, 17, 33, 2))  # five NEW lengths at K 1, speculation off
    assert engine.set_window(8, spec_on=True)
    run((6,))
    assert engine.set_window(1, spec_on=False)
    run((11,))
    assert engine.graph_captures == warm
    assert sorted(built) == [(1, 0), (1, 4), (8, 0)]
    assert set(engine._window_cache) == {(8, 4), (1, 4), (8, 0), (1, 0)}


def test_dense_step_runner_matches_jax_batch_engine(both):  # noqa: F811
    from dora_tpu.models.hf import qwen2 as jq
    from dora_tpu_torch.models.hf import qwen2 as tq
    from tests.test_torch_dense_engine import _drive

    cfg, qparams, tcfg, tparams = both
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, size=n).tolist() for n in (3, 7, 12)]
    port = tq.make_batch_engine(tparams, tcfg, max_slots=3, device="cpu")
    tokens, positions, caches = port.tokens, port.positions, port.caches
    got = _drive(port, prompts, _MAX_NEW)
    want = _drive(jq.make_batch_engine(qparams, cfg, max_slots=3), prompts, _MAX_NEW)
    assert got == want
    assert port.tokens is tokens and port.positions is positions and port.caches is caches
    assert port.graph_captures == 1 and port._runner._args[0] is tokens
    port.submit("again", prompts[0], 4)
    port.positions = port.positions.clone()
    with pytest.raises(ValueError, match="argument 2 is not the static buffer"):
        port.step()
