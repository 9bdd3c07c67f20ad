"""The port's paged serving path against dora_tpu's, on the CPU.

On the tiny random ``transformers`` Qwen2 (no download), the port's paged
engine (``dora_tpu_torch``) over ``params_from_jax`` of the JAX package's
quantized weights emits exactly the greedy tokens of
``dora_tpu.models.hf.qwen2.make_paged_engine``: staggered admissions, a
prompt longer than one chunk, K in {1, 8}, and streams frozen mid-window.
Both run in f32 on the CPU; the port takes its plain PyTorch path there.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch


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
    path = tmp_path_factory.mktemp("qwen2-torch-paged")
    model.save_pretrained(path, safe_serialization=True)
    return path


@pytest.fixture(scope="module")
def both(tiny_qwen2):
    """(jax cfg, jax quantized params, port cfg, port params) on the same
    weights: the port's from ``params_from_jax``."""
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


def _drain(streams: dict, events) -> None:
    for rid, token, _done in events:
        streams[rid].append(token)


def _assert_same_tree(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _assert_same_tree(a[k], b[k], f"{path}/{k}")
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a, b), path


def test_load_and_quantize_match_params_from_jax(tiny_qwen2, both):
    """The port's own load + quantize_decode gives, leaf for leaf and byte
    for byte, the tree params_from_jax makes of the JAX package's."""
    from dora_tpu_torch.models.hf import qwen2 as tq

    cfg, _, tcfg, tparams = both
    assert tcfg == tq.Qwen2Config(**cfg.__dict__)
    lcfg, lparams = tq.load(tiny_qwen2, max_seq=64, device="cpu")
    _assert_same_tree(tq.quantize_decode(lparams, lcfg), tparams)


@pytest.mark.parametrize("window", (1, 8))
def test_port_matches_jax_across_staggered_admissions(both, window):
    """Staggered admissions, including a 37-token prompt spanning five
    8-token chunks admitted while other streams decode."""
    from dora_tpu.models.hf import qwen2 as jq
    from dora_tpu_torch.models.hf import qwen2 as tq

    cfg, qparams, tcfg, tparams = both
    rng = np.random.default_rng(5)
    plens = (3, 7, 12, 37, 5)
    prompts = [rng.integers(0, cfg.vocab, size=n).tolist() for n in plens]
    max_new = 10

    def drive(engine):
        streams = {f"r{i}": [] for i in range(len(plens))}
        engine.submit("r0", prompts[0], max_new)
        for _ in range(3):
            _drain(streams, engine.step())
        engine.submit("r1", prompts[1], max_new)
        engine.submit("r2", prompts[2], max_new)
        _drain(streams, engine.step())
        engine.submit("r3", prompts[3], max_new)
        _drain(streams, engine.step())
        engine.submit("r4", prompts[4], max_new)
        for _ in range(300):
            if not engine.active:
                break
            _drain(streams, engine.step())
        assert engine.active == 0
        assert engine.free_pages == engine.allocator.num_pages - 1
        return streams

    want = drive(jq.make_paged_engine(
        qparams, cfg, max_slots=5, page_size=8, chunk=8, window=window))
    port = tq.make_paged_engine(
        tparams, tcfg, max_slots=5, page_size=8, chunk=8, window=window,
        device="cpu")
    got = drive(port)
    port.check_invariants()
    assert all(len(s) == max_new for s in got.values())
    assert got == want


def test_port_freezes_streams_mid_window_like_jax(both):
    """EOS inside a K=8 window for one stream and an expiring max_new for
    another: the port freezes each the tick it finishes and emits the JAX
    engine's streams."""
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
        return streams

    # eos = r0's 6th greedy token, so it lands strictly inside a window
    free = drive(jq.make_paged_engine(
        qparams, cfg, max_slots=2, page_size=8, chunk=8, window=8))
    eos = free["r0"][5]
    want = drive(jq.make_paged_engine(
        qparams, cfg, max_slots=2, page_size=8, chunk=8, window=8, eos=eos))
    got = drive(tq.make_paged_engine(
        tparams, tcfg, max_slots=2, page_size=8, chunk=8, window=8, eos=eos,
        device="cpu"))
    assert got == want
    assert len(got["r0"]) == 6 and len(got["r1"]) == 5


def test_serve_prompts_holds_back_until_pages_free(both):
    """The port's serving loop admits in order and parks requests the pool
    cannot hold yet; every stream still finishes with max_new tokens."""
    from dora_tpu_torch.models.hf import qwen2 as tq
    from dora_tpu_torch.nodehub.llm_server import serve_prompts

    _, _, tcfg, tparams = both
    # 9 usable pages of 8 rows against 13 needed: requests wait for pages
    # although slots are free.
    engine = tq.make_paged_engine(
        tparams, tcfg, max_slots=4, page_size=8, chunk=8, num_pages=10,
        window=4, device="cpu")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, tcfg.vocab, size=n).tolist() for n in (20, 9, 17, 3)]
    need = [engine.pages_needed(len(p), 12) for p in prompts]
    assert need == [4, 3, 4, 2] and sum(need) > 9
    peak = []
    out, ttft = serve_prompts(
        engine, prompts, 12, on_token=lambda *_: peak.append(engine.allocator.in_use))
    assert max(peak) <= 9 and engine.allocator.peak_in_use <= 9
    assert all(len(out[i]) == 12 for i in range(4))
    assert set(ttft) == {0, 1, 2, 3}
    assert engine.free_pages == 9
    # Held-back scheduling changes when a stream runs, never its tokens.
    roomy = tq.make_paged_engine(
        tparams, tcfg, max_slots=4, page_size=8, chunk=8, window=4,
        device="cpu")
    assert serve_prompts(roomy, prompts, 12)[0] == out


def test_llm_server_main_serves_a_checkpoint_like_jax(tiny_qwen2, both, tmp_path,
                                                      monkeypatch, capsys):
    """The serving entry loads the checkpoint named by DORA_HF_CHECKPOINT,
    quantizes it, builds the engine from the env knobs and answers token-id
    prompts: the tokens equal the JAX paged engine's."""
    import json

    from dora_tpu.models.hf import qwen2 as jq
    from dora_tpu_torch.nodehub import llm_server

    cfg, qparams, _, _ = both
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, cfg.vocab, size=n).tolist() for n in (6, 19, 2)]
    path = tmp_path / "prompts.json"
    path.write_text(json.dumps(prompts))
    for key, value in (("DORA_HF_CHECKPOINT", str(tiny_qwen2)), ("DORA_MAX_SEQ", "64"),
                       ("DORA_PAGE_SIZE", "8"), ("DORA_PREFILL_CHUNK", "8"),
                       ("DORA_BATCH_SLOTS", "2"), ("DORA_MULTISTEP_K", "4")):
        monkeypatch.setenv(key, value)
    assert llm_server.main(["--prompts", str(path), "--max-new", "7", "--device", "cpu"]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [line["id"] for line in lines] == [0, 1, 2]

    engine = jq.make_paged_engine(qparams, cfg, max_slots=3, page_size=8, chunk=8, window=4)
    want = {f"r{i}": [] for i in range(3)}
    for i, p in enumerate(prompts):
        engine.submit(f"r{i}", p, 7)
    while engine.active:
        _drain(want, engine.step())
    assert [line["tokens"] for line in lines] == [want[f"r{i}"] for i in range(3)]


def test_allocator_null_page_all_or_nothing_and_custody():
    from dora_tpu_torch.models.batch_engine import PageAllocator

    a = PageAllocator(8)
    assert a.free_pages == 7  # page 0 reserved
    grant = a.alloc(7)
    assert sorted(grant) == list(range(1, 8))
    assert a.alloc(1) is None  # empty pool refuses
    a.free(grant[:3])
    assert a.alloc(4) is None and a.free_pages == 3  # no partial grant
    a.ref(grant[3:4])
    with pytest.raises(RuntimeError, match="shared page"):
        a.free(grant[3:4])
    a.unref(grant[3:4])
    a.free(grant[3:])
    with pytest.raises(RuntimeError, match="double free"):
        a.unref(grant[3:4])
    with pytest.raises(RuntimeError, match="not allocated"):
        a.ref([grant[3]])
    a.check_invariants()
    assert a.free_pages == 7 and a.peak_in_use == 7


def test_admission_math_matches_jax():
    """pages_needed / fits / can_admit agree with the JAX engine's over a
    grid of prompt lengths and budgets, with a partly granted pool."""
    from dora_tpu.models.batch_engine import PagedBatchEngine as JEngine
    from dora_tpu_torch.models.batch_engine import PagedBatchEngine as TEngine

    kw = dict(init_pool=lambda n: {}, chunk_prefill=None, window_step=None,
              max_slots=2, max_seq=64, page_size=8, chunk=16, num_pages=9)
    j, t = JEngine(**kw), TEngine(**kw, device="cpu")
    for e in (j, t):
        e.allocator.alloc(3)
    for n in (1, 3, 15, 16, 17, 33, 60, 62, 64):
        for new in (1, 2, 4, 8, 30):
            assert t.pages_needed(n, new) == j.pages_needed(n, new), (n, new)
            assert t.fits(n, new) == j.fits(n, new), (n, new)
            assert t.can_admit(n, new) == j.can_admit(n, new), (n, new)


def test_make_engine_reads_the_front_door_knobs(both, monkeypatch):
    """As dora_tpu's make_engine: the prefix cache is on unless
    DORA_PREFIX_CACHE=0 and DORA_PREFIX_CACHE_PAGES caps it; DORA_SPEC_K and
    DORA_SPEC_NGRAM reach the engine. DORA_PAGED_KV=0 builds the dense
    batch engine (4 slots by default), as there."""
    from dora_tpu_torch.models.batch_engine import BatchEngine
    from dora_tpu_torch.nodehub.llm_server import make_engine

    _, _, tcfg, tparams = both
    for key in ("DORA_PREFIX_CACHE", "DORA_PREFIX_CACHE_PAGES", "DORA_SPEC_K",
                "DORA_SPEC_NGRAM", "DORA_PAGED_KV", "DORA_BATCH_SLOTS"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("DORA_PAGE_SIZE", "8")
    monkeypatch.setenv("DORA_PREFILL_CHUNK", "8")
    eng = make_engine(tparams, tcfg, device="cpu")
    assert eng.prefix_cache is not None and eng.prefix_cache.max_pages == 0
    assert eng.spec_k == 0
    monkeypatch.setenv("DORA_PREFIX_CACHE_PAGES", "8")
    monkeypatch.setenv("DORA_SPEC_K", "3")
    monkeypatch.setenv("DORA_SPEC_NGRAM", "3")
    eng = make_engine(tparams, tcfg, device="cpu")
    assert eng.prefix_cache.max_pages == 8
    assert (eng.spec_k, eng.spec_ngram, eng.spec_headroom()) == (3, 3, 4)
    monkeypatch.setenv("DORA_PREFIX_CACHE", "0")
    assert make_engine(tparams, tcfg, device="cpu").prefix_cache is None
    monkeypatch.setenv("DORA_PAGED_KV", "0")
    dense = make_engine(tparams, tcfg, device="cpu")
    assert isinstance(dense, BatchEngine) and dense.max_slots == 4
