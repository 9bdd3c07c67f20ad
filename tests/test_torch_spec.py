"""The port's prompt-lookup speculation against dora_tpu's, on the CPU.

``spec_decode.lookup`` (batched over streams on torch tensors) drafts
exactly what the JAX package's one-stream lookup drafts, and the port's
paged engine with speculation in its window emits exactly the greedy
tokens of ``dora_tpu.models.hf.qwen2.make_paged_engine`` with speculation
on, on the tiny random ``transformers`` Qwen2 (no download): staggered
admissions, a prompt longer than one chunk, spec_k in {2, 4}, K in {1, 8},
completion inside a verified chunk, and speculation paused and resumed
mid-stream. Both run in f32 on the CPU; the port takes its plain PyTorch
path there, and the JAX package runs its Pallas kernels in interpret mode.
Tokens and counts are compared exactly.
"""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(jax cfg, jax quantized params, port cfg, port params) on the same
    weights of a tiny random Qwen2 checkpoint."""
    from transformers import Qwen2Config, Qwen2ForCausalLM

    from dora_tpu.models.hf import qwen2 as jq
    from dora_tpu_torch.models.hf import qwen2 as tq

    config = Qwen2Config(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, rope_theta=10000.0,
        rms_norm_eps=1e-6, tie_word_embeddings=False,
        attn_implementation="eager",
    )
    torch.manual_seed(0)
    path = tmp_path_factory.mktemp("qwen2-torch-spec")
    Qwen2ForCausalLM(config).eval().save_pretrained(path, safe_serialization=True)
    cfg, params = jq.load(path, max_seq=64)
    os.environ["DORA_INT8_DECODE"] = "1"
    try:
        qparams = jq.quantize_decode(params, cfg)
    finally:
        os.environ.pop("DORA_INT8_DECODE", None)
    tcfg, _ = tq.load(path, max_seq=64, device="cpu")
    return cfg, qparams, tcfg, tq.params_from_jax(qparams, device="cpu")


def _drain(streams: dict, events) -> None:
    for rid, token, _done in events:
        streams[rid].append(token)


# ---------------------------------------------------------------------------
# the draft rule
# ---------------------------------------------------------------------------


def test_lookup_matches_jax_exactly():
    """Seeded histories over a 3-token vocabulary (many matches) at every
    fill length, plus a history with no earlier match (the last token
    repeats) and one whose match start is clipped to seq - k."""
    from dora_tpu.models import spec_decode as jspec
    from dora_tpu_torch.models import spec_decode as tspec

    seq, k, ngram = 24, 4, 2
    rng = np.random.default_rng(7)
    hist = rng.integers(0, 3, size=(seq + 1, seq)).astype(np.int32)
    hlen = np.arange(seq + 1, dtype=np.int32)  # 0 .. seq filled
    no_match = np.arange(100, 100 + seq, dtype=np.int32)[None]
    clipped = np.zeros((1, seq), np.int32)
    clipped[0, 16:20] = [5, 6, 7, 8]
    clipped[0, 20:22] = [5, 6]  # trailing ngram matches at 16: start 18 > seq - k
    hist = np.concatenate([hist, no_match, clipped])
    hlen = np.concatenate([hlen, [seq], [22]]).astype(np.int32)
    for ng in (ngram, 3):
        got = tspec.lookup(torch.from_numpy(hist), torch.from_numpy(hlen), seq, k, ng)
        assert got.dtype == torch.int32 and got.shape == (len(hist), k)
        want = np.stack([
            np.asarray(jspec.lookup(jnp.asarray(h), jnp.asarray(n), seq, k, ng))
            for h, n in zip(hist, hlen)
        ])
        np.testing.assert_array_equal(got.numpy(), want)
    assert got[-2].tolist() == [hist[-2, seq - 1]] * k
    assert tspec.SPEC_K == jspec.SPEC_K and tspec.SPEC_NGRAM == jspec.SPEC_NGRAM
    assert tspec.spec_headroom(3) == jspec.spec_headroom(3) == 4


def test_window_row_stats_match_jax():
    from dora_tpu.models import vlm as jvlm
    from dora_tpu_torch.models import vlm as tvlm

    k, m = 3, 3
    for row in ([5, 6, -1, 7, -1, -1, 8, 9, 9, 1], [5, -1, -1, 6, 7, -1, -1, -1, -1, 0],
                [-1] * 9 + [0], [1, 2, 3, 4, 5, 6, 7, 8, 9, 1]):
        assert tvlm.spec_window_row_stats(row, k, m) == jvlm.spec_window_row_stats(row, k, m)
    for row in ([4, 5, 6, 1], [4, -1, -1, 0], [4, 5, 6, 0], [-1, -1, -1, 0]):
        assert tvlm.window_row_stats(row, 3) == jvlm.window_row_stats(row, 3)


# ---------------------------------------------------------------------------
# the engine with speculation
# ---------------------------------------------------------------------------

_PLENS = (3, 7, 12, 5)
_MAX_NEW = 10


def _prompts(vocab):
    rng = np.random.default_rng(5)
    return [rng.integers(0, vocab, size=n).tolist() for n in _PLENS]


def _drive_staggered(engine, prompts, on_step=None):
    """tests/test_paged_engine.py's spec scenario: r0 decodes alone, r1 and
    r2 (12 tokens: two chunks) join, then r3. ``on_step(n, engine)`` runs
    before the n-th step."""
    streams = {f"r{i}": [] for i in range(len(prompts))}
    n = [0]

    def step():
        if on_step is not None:
            on_step(n[0], engine)
        n[0] += 1
        _drain(streams, engine.step())

    engine.submit("r0", prompts[0], _MAX_NEW)
    for _ in range(3):
        step()
    engine.submit("r1", prompts[1], _MAX_NEW)
    engine.submit("r2", prompts[2], _MAX_NEW)
    step()
    engine.submit("r3", prompts[3], _MAX_NEW)
    for _ in range(300):
        if not engine.active:
            break
        step()
    assert engine.active == 0
    assert engine.free_pages == engine.allocator.num_pages - 1
    engine.check_invariants()
    return streams


@pytest.fixture(scope="module")
def jax_spec_streams(both):
    """The JAX engine's streams with speculation on (spec_k 2, K 8); its own
    tests hold them equal at every other (spec_k, K)."""
    from dora_tpu.models.hf import qwen2 as jq

    cfg, qparams, _, _ = both
    engine = jq.make_paged_engine(qparams, cfg, max_slots=4, page_size=8, chunk=8,
                                  window=8, spec_k=2)
    return _drive_staggered(engine, _prompts(cfg.vocab))


@pytest.mark.parametrize("spec_k", (2, 4))
@pytest.mark.parametrize("window", (1, 8))
def test_port_spec_engine_matches_jax(both, jax_spec_streams, spec_k, window):
    from dora_tpu_torch.models import vlm
    from dora_tpu_torch.models.hf import qwen2 as tq

    _, _, tcfg, tparams = both
    engine = tq.make_paged_engine(tparams, tcfg, max_slots=4, page_size=8, chunk=8,
                                  window=window, spec_k=spec_k, device="cpu")
    assert engine.spec_k == spec_k and engine.spec_headroom() == spec_k + 1
    inner = engine.window_step
    passes = []  # (tokens emitted, verification passes) per live row per window

    def watched(*args):
        # the window carries the mask forward in place: read it before
        active = args[4].clone()
        out = inner(*args)
        mat = out[0]
        for b in torch.nonzero(active).flatten().tolist():
            n_emit, frozen = vlm.spec_window_row_stats(mat[b].tolist(), window, spec_k + 1)
            passes.append((n_emit, window if frozen is None else frozen + 1))
        return out

    engine.window_step = watched
    got = _drive_staggered(engine, _prompts(tcfg.vocab))
    assert all(len(s) == _MAX_NEW for s in got.values())
    assert got == jax_spec_streams
    # drafts were accepted: some pass emitted more than its bonus token
    assert sum(e for e, _ in passes) > sum(p for _, p in passes)


def test_port_spec_off_matches_jax_spec_on(both, jax_spec_streams):
    """Speculation changes how many tokens a window emits, never which."""
    from dora_tpu_torch.models.hf import qwen2 as tq

    _, _, tcfg, tparams = both
    engine = tq.make_paged_engine(tparams, tcfg, max_slots=4, page_size=8, chunk=8,
                                  window=8, spec_k=0, device="cpu")
    assert _drive_staggered(engine, _prompts(tcfg.vocab)) == jax_spec_streams


def test_set_window_pauses_and_resumes_speculation(both, jax_spec_streams):
    """The SLO autotuner's actuator: K and speculation change at window
    boundaries mid-stream; windows are built once per (K, spec_k) and the
    tokens do not move."""
    from dora_tpu_torch.models.hf import qwen2 as tq

    _, _, tcfg, tparams = both
    engine = tq.make_paged_engine(tparams, tcfg, max_slots=4, page_size=8, chunk=8,
                                  window=8, spec_k=2, device="cpu")
    plan = [(4, False), (4, True), (2, False), (8, True)]
    changed = []

    def toggle(n, eng):
        k, on = plan[n % len(plan)]
        changed.append(eng.set_window(k, spec_on=on))
        assert eng.window == k and eng.spec_k == (2 if on else 0)
        assert eng.spec_headroom() == 3  # follows the configured width

    got = _drive_staggered(engine, _prompts(tcfg.vocab), on_step=toggle)
    assert got == jax_spec_streams
    assert len(changed) >= 6 and all(changed)
    assert not engine.set_window(engine.window, spec_on=engine.spec_k > 0)
    assert set(engine._window_cache) == {(8, 2), (4, 0), (4, 2), (2, 0)}


@pytest.mark.parametrize("window", (1, 8))
def test_port_spec_freezes_streams_mid_chunk_like_jax(both, window):
    """EOS at a draft position for one stream and max_new expiring inside a
    verified chunk for the other: the emission stops at the completing
    token, the stream freezes, and the streams equal the JAX spec engine's
    (and its spec-off engine's)."""
    from dora_tpu.models.hf import qwen2 as jq
    from dora_tpu_torch.models.hf import qwen2 as tq

    cfg, qparams, tcfg, tparams = both
    rng = np.random.default_rng(31)
    prompts = [rng.integers(0, cfg.vocab, size=n).tolist() for n in (4, 6)]
    max_new = (12, 5)

    def drive(engine):
        streams = {"r0": [], "r1": []}
        engine.submit("r0", prompts[0], max_new[0])
        engine.submit("r1", prompts[1], max_new[1])
        for _ in range(100):
            if not engine.active:
                break
            _drain(streams, engine.step())
        assert engine.active == 0
        assert engine.free_pages == engine.allocator.num_pages - 1
        return streams

    free = drive(tq.make_paged_engine(tparams, tcfg, max_slots=2, page_size=8, chunk=8,
                                      window=8, device="cpu"))
    eos = free["r0"][5]
    want = drive(jq.make_paged_engine(qparams, cfg, max_slots=2, page_size=8, chunk=8,
                                      window=window, eos=eos, spec_k=2))
    assert len(want["r0"]) == 6 and len(want["r1"]) == 5
    for spec_k in (0, 2, 4):
        got = drive(tq.make_paged_engine(tparams, tcfg, max_slots=2, page_size=8,
                                         chunk=8, window=window, eos=eos,
                                         spec_k=spec_k, device="cpu"))
        assert got == want, f"spec_k={spec_k} K={window}"


def test_spec_headroom_admission_math_matches_jax():
    """fits / pages_needed (with and without cached tokens) / can_admit
    with the verify tail reserved agree with the JAX engine's over a grid,
    and a request that fills max_seq exactly is refused spec-on."""
    from dora_tpu.models.batch_engine import PagedBatchEngine as JEngine
    from dora_tpu_torch.models.batch_engine import PagedBatchEngine as TEngine

    kw = dict(init_pool=lambda n: {}, chunk_prefill=None, window_step=None,
              max_slots=2, max_seq=64, page_size=8, chunk=16, num_pages=9)
    for spec_k in (0, 2, 4):
        j = JEngine(**kw, spec_k=spec_k)
        t = TEngine(**kw, spec_k=spec_k, device="cpu")
        assert t.spec_headroom() == j.spec_headroom()
        for e in (j, t):
            e.allocator.alloc(3)
        for n in (1, 3, 15, 16, 17, 33, 51, 56, 60, 64):
            for new in (1, 2, 4, 8, 30):
                assert t.fits(n, new) == j.fits(n, new), (spec_k, n, new)
                assert t.can_admit(n, new) == j.can_admit(n, new), (spec_k, n, new)
                for cached in (0, 8, 16):
                    if cached < n:
                        assert (t.pages_needed(n, new, cached)
                                == j.pages_needed(n, new, cached)), (spec_k, n, new, cached)
    off = TEngine(**kw, device="cpu")
    on = TEngine(**kw, spec_k=4, device="cpu")
    assert on.spec_headroom() == 5 and off.spec_headroom() == 0
    assert off.fits(56, 8) and not on.fits(56, 8) and on.fits(51, 8)
    assert on.pages_needed(3, 30) == off.pages_needed(3, 35)
