"""The port's shared-prefix cache against dora_tpu's, on the CPU.

The radix tree (``dora_tpu_torch.models.prefix_cache``, the port's own copy)
answers every operation of an identical sequence exactly as the JAX
package's ``PrefixCache`` does: longest prefix and the mid-page flag,
first-writer-wins dedup, LRU leaf-first eviction that skips pinned and
shared pages, the ``max_pages`` cap, hash chains and digests. On the tiny
random ``transformers`` Qwen2 (no download), the port's paged engine with
the cache on emits the tokens of the same engine cold, at spec_k in {0, 2}
and K in {1, 8}, with the JAX engine's hit, miss, hit-token, copy-on-write
and eviction counts; page custody holds after every scenario. Tokens and
counts are compared exactly.
"""

from __future__ import annotations

import os

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
    path = tmp_path_factory.mktemp("qwen2-torch-prefix")
    Qwen2ForCausalLM(config).eval().save_pretrained(path, safe_serialization=True)
    cfg, params = jq.load(path, max_seq=64)
    os.environ["DORA_INT8_DECODE"] = "1"
    try:
        qparams = jq.quantize_decode(params, cfg)
    finally:
        os.environ.pop("DORA_INT8_DECODE", None)
    tcfg, _ = tq.load(path, max_seq=64, device="cpu")
    return cfg, qparams, tcfg, tq.params_from_jax(qparams, device="cpu")


# ---------------------------------------------------------------------------
# the radix tree, operation by operation against the JAX package's
# ---------------------------------------------------------------------------


class _Pair:
    """The JAX package's allocator + cache and the port's, driven by the
    same calls; every call returns the common result after asserting that
    both sides gave it."""

    def __init__(self, num_pages=32, page_size=4, **kw):
        from dora_tpu.models.batch_engine import PageAllocator as JA
        from dora_tpu.models.prefix_cache import PrefixCache as JC
        from dora_tpu_torch.models.batch_engine import PageAllocator as TA
        from dora_tpu_torch.models.prefix_cache import PrefixCache as TC

        self.ja, self.ta = JA(num_pages), TA(num_pages)
        self.jc, self.tc = JC(self.ja, page_size, **kw), TC(self.ta, page_size, **kw)

    def alloc(self, n):
        return self._same(self.ja.alloc(n), self.ta.alloc(n))

    def a(self, name, *args):
        return self._same(getattr(self.ja, name)(*args), getattr(self.ta, name)(*args))

    def c(self, name, *args):
        return self._same(getattr(self.jc, name)(*args), getattr(self.tc, name)(*args))

    def check(self):
        self.ja.check_invariants()
        self.ta.check_invariants()
        assert self.tc.stats() == self.jc.stats()
        assert sorted(self.tc.pages()) == sorted(self.jc.pages())
        assert self.tc.digest() == self.jc.digest()
        assert self.tc.size == self.jc.size
        assert self.ta.free_pages == self.ja.free_pages

    @staticmethod
    def _same(j, t):
        assert t == j, (t, j)
        return t


def test_radix_longest_prefix_and_mid_page_flag_like_jax():
    p = _Pair()
    ids = list(range(1, 13))  # 3 full pages of 4
    pages = p.alloc(3)
    assert p.c("insert", ids, pages) == 3
    assert p.c("lookup", ids) == (12, pages, False)
    m, got, mid = p.c("lookup", ids[:5] + [99, 99, 99])  # diverges inside page 2
    assert (m, got) == (4, pages[:1]) and mid
    m, got, mid = p.c("lookup", ids[:8] + [99, 99])  # at a page boundary
    assert (m, got) == (8, pages[:2]) and not mid
    assert p.c("lookup", [77, 78, 79, 80])[0] == 0
    p.check()


def test_radix_dedup_first_writer_wins_like_jax():
    p = _Pair()
    ids = list(range(1, 9))
    first = p.alloc(2)
    p.c("insert", ids, first)
    dup = p.alloc(2)
    assert p.c("insert", ids, dup) == 0
    assert p.c("lookup", ids)[1] == first
    p.a("free", dup)  # the duplicate stays in its stream's custody
    p.check()


def test_radix_lru_eviction_leaf_first_skips_pinned_and_shared_like_jax():
    p = _Pair()
    base = list(range(1, 9))
    pa, pb = p.alloc(3), p.alloc(3)
    p.c("insert", base + [11, 12, 13, 14], pa)
    p.c("insert", base + [21, 22, 23, 24], pb)
    p.c("lookup", base + [21, 22, 23, 24])  # A's leaf is now LRU
    p.a("unref", pa)
    p.a("unref", pb)
    assert p.c("evictable_pages") == 4
    assert p.c("evict", 1) == 1
    assert p.c("lookup", base + [11, 12, 13, 14])[0] == 8
    assert p.c("lookup", base + [21, 22, 23, 24])[0] == 12
    assert p.c("pin", base + [21, 22, 23, 24]) == 12
    assert p.c("evictable_pages") == 0 and p.c("evict", 10) == 0
    p.c("unpin", base + [21, 22, 23, 24])
    shared = p.c("lookup", base)[1]
    p.a("ref", shared)  # a live stream shares the base
    assert p.c("evictable_pages") == 1 and p.c("evict", 10) == 1
    p.a("unref", shared)
    assert p.c("flush") == 2
    p.check()
    assert p.tc.size == 0 and p.ta.free_pages == p.ta.num_pages - 1


def test_radix_max_pages_cap_and_hash_chains_like_jax():
    from dora_tpu.models.prefix_cache import prompt_hash_chain as jchain
    from dora_tpu_torch.models.prefix_cache import prompt_hash_chain as tchain

    p = _Pair(max_pages=2)
    ids = list(range(1, 13))
    pages = p.alloc(3)
    p.c("insert", ids, pages)
    assert p.tc.size == 3  # the inserting stream still shares them
    p.a("unref", pages)
    other = p.alloc(1)
    p.c("insert", [50, 51, 52, 53], other)
    p.a("unref", other)
    assert p.tc.size == 2 and p.tc.evicted_pages == 2
    p.check()
    for adapter in (None, "tenant"):
        assert tchain(ids + [7], 4, adapter) == jchain(ids + [7], 4, adapter)


# ---------------------------------------------------------------------------
# the engine with the cache on
# ---------------------------------------------------------------------------


def _run_sequential(engine, prompts, max_new):
    """One stream at a time to completion (as tests/test_prefix_cache.py
    runs them), so stream n+1 can hit what stream n cached. Returns (tokens
    per rid, prefill chunks per stream)."""
    out: dict[str, list[int]] = {}
    chunks = []
    for i, p in enumerate(prompts):
        c0 = engine.chunks_run
        engine.submit(f"r{i}", p, max_new)
        while engine.active or engine.prefilling:
            for rid, tok, _done in engine.step():
                out.setdefault(rid, []).append(tok)
        chunks.append(engine.chunks_run - c0)
    engine.check_invariants()
    return out, chunks


def _shared_prompts(vocab):
    rng = np.random.default_rng(5)
    tmpl = rng.integers(0, vocab, size=24).tolist()
    tails = [rng.integers(0, vocab, size=n).tolist() for n in (2, 3, 2)]
    return [tmpl + tails[0], tmpl + tails[1], tmpl[:20] + tails[2]]


@pytest.fixture(scope="module")
def jax_shared(both):
    """The JAX engine with the cache on over the shared-template prompts:
    (tokens, cache stats)."""
    from dora_tpu.models.hf import qwen2 as jq

    cfg, qparams, _, _ = both
    eng = jq.make_paged_engine(qparams, cfg, max_slots=4, page_size=8, chunk=16,
                               window=8, prefix_cache=True)
    out, _ = _run_sequential(eng, _shared_prompts(cfg.vocab), 6)
    return out, eng.prefix_cache.stats()


@pytest.mark.parametrize("window", (1, 8))
@pytest.mark.parametrize("spec_k", (0, 2))
def test_shared_vs_cold_identity_like_jax(both, jax_shared, spec_k, window):
    """A template of 24 tokens, two prompts that extend it and one that
    parts from it mid-page (tests/test_prefix_cache.py:372): cache on emits
    the cache-off tokens and the JAX engine's, prefills fewer chunks, and
    counts the JAX engine's hits, misses, hit tokens and copy-on-write
    boundaries. Attention really reads the shared rows here."""
    from dora_tpu_torch.models.hf import qwen2 as tq

    _, _, tcfg, tparams = both
    prompts = _shared_prompts(tcfg.vocab)

    def build(cache):
        return tq.make_paged_engine(tparams, tcfg, max_slots=4, page_size=8, chunk=16,
                                    window=window, spec_k=spec_k, prefix_cache=cache,
                                    device="cpu")

    cold, cc = _run_sequential(build(False), prompts, 6)
    eng = build(True)
    warm, wc = _run_sequential(eng, prompts, 6)
    want, stats = jax_shared
    assert warm == cold == want
    pc = eng.prefix_cache
    assert pc.stats() == stats
    assert pc.hits == 2 and pc.misses == 1 and pc.cow_copies >= 1
    assert wc[1] < cc[1] and wc[2] < cc[2]
    assert eng.free_pages + pc.size == eng.allocator.num_pages - 1


def test_shared_pages_and_custody_while_streams_live(both):
    """Two live streams on one cached template: the shared pages carry one
    reference per stream plus the cache's, and custody holds mid-flight."""
    from dora_tpu_torch.models.hf import qwen2 as tq

    _, _, tcfg, tparams = both
    prompts = _shared_prompts(tcfg.vocab)
    eng = tq.make_paged_engine(tparams, tcfg, max_slots=4, page_size=8, chunk=16,
                               window=2, spec_k=2, prefix_cache=True, device="cpu")
    _run_sequential(eng, prompts[:1], 6)
    eng.submit("a", prompts[0], 6)
    eng.submit("b", prompts[1], 6)
    assert eng.shared_pages == 6  # 3 template pages each
    assert all(eng.allocator.refcount(p) == 3 for p in eng.slots[0].pages[:3])
    eng.check_invariants()
    while eng.active:
        eng.step()
        eng.check_invariants()
    assert eng.shared_pages == 0


def test_eviction_under_pressure_then_readmission_like_jax(both):
    """8 usable pages: the cached template gives way to an unrelated prompt,
    then comes back cold (tests/test_prefix_cache.py:414); tokens equal the
    cache-off run and the JAX engine's, with its counts."""
    from dora_tpu.models.hf import qwen2 as jq
    from dora_tpu_torch.models.hf import qwen2 as tq

    cfg, qparams, tcfg, tparams = both
    rng = np.random.default_rng(9)
    tmpl = rng.integers(0, cfg.vocab, size=32).tolist()
    other = rng.integers(0, cfg.vocab, size=40).tolist()
    prompts = [tmpl, other, tmpl]
    kw = dict(max_slots=2, page_size=8, chunk=16, window=8, num_pages=9)
    jeng = jq.make_paged_engine(qparams, cfg, prefix_cache=True, **kw)
    want, _ = _run_sequential(jeng, prompts, 8)
    cold, _ = _run_sequential(
        tq.make_paged_engine(tparams, tcfg, prefix_cache=False, device="cpu", **kw),
        prompts, 8)
    eng = tq.make_paged_engine(tparams, tcfg, prefix_cache=True, device="cpu", **kw)
    warm, _ = _run_sequential(eng, prompts, 8)
    assert warm == cold == want
    assert eng.prefix_cache.stats() == jeng.prefix_cache.stats()
    assert eng.prefix_cache.evicted_pages >= 2


def test_sharing_backs_off_rather_than_block_admission_like_jax(both):
    """The chunk-overhang geometry of tests/test_prefix_cache.py:306 on the
    real model: sharing the whole 3-page template would need 5 pages where
    the cold grant needs 4, so with 4 usable pages the grant backs off one
    shared page (16 hit tokens, not 24)."""
    from dora_tpu.models.hf import qwen2 as jq
    from dora_tpu_torch.models.hf import qwen2 as tq

    cfg, qparams, tcfg, tparams = both
    tmpl = list(range(1, 25))
    prompts = [tmpl, tmpl + [50, 51]]
    kw = dict(max_slots=1, page_size=8, chunk=16, window=2, num_pages=5)
    jeng = jq.make_paged_engine(qparams, cfg, prefix_cache=True, **kw)
    want, _ = _run_sequential(jeng, prompts, 2)
    eng = tq.make_paged_engine(tparams, tcfg, prefix_cache=True, device="cpu", **kw)
    got, _ = _run_sequential(eng, prompts, 2)
    assert got == want
    pc = eng.prefix_cache
    assert pc.hits == 1 and pc.hit_tokens == 16 and pc.cow_copies >= 1
    assert pc.stats() == jeng.prefix_cache.stats()


def test_front_door_serves_a_shared_system_prefix(both, monkeypatch):
    """chip_smoke.py's phase 6 at a tiny size: the engine make_engine builds
    (cache on by default, DORA_SPEC_K=2) serves one request until its first
    token, then the others through serve_prompts beside it; each of them
    hits the shared system prefix, and every stream emits the tokens of the
    spec-off, cache-off engine."""
    from dora_tpu_torch.models.hf import qwen2 as tq
    from dora_tpu_torch.nodehub.llm_server import make_engine, serve_prompts

    _, _, tcfg, tparams = both
    for key in ("DORA_PREFIX_CACHE", "DORA_PREFIX_CACHE_PAGES", "DORA_SPEC_NGRAM",
                "DORA_PAGED_KV", "DORA_BATCH_SLOTS"):
        monkeypatch.delenv(key, raising=False)
    for key, value in (("DORA_SPEC_K", "2"), ("DORA_PAGE_SIZE", "8"),
                       ("DORA_PREFILL_CHUNK", "8"), ("DORA_MULTISTEP_K", "4")):
        monkeypatch.setenv(key, value)
    rng = np.random.default_rng(4)
    system = rng.integers(0, tcfg.vocab, size=16).tolist()
    prompts = [system + rng.integers(0, tcfg.vocab, size=n).tolist() for n in (3, 5, 9, 12)]
    eng = make_engine(tparams, tcfg, device="cpu")
    assert eng.spec_k == 2 and eng.prefix_cache is not None
    eng.submit("first", prompts[0], 8)
    first: list[int] = []
    while not first:
        first += [tok for _rid, tok, _done in eng.step()]
    out, ttft = serve_prompts(eng, prompts[1:], 8, others={"first": first})
    pc = eng.prefix_cache
    assert (pc.hits, pc.misses, pc.hit_tokens) == (3, 1, 3 * 16)
    assert set(ttft) == {0, 1, 2}
    eng.check_invariants()
    cold = tq.make_paged_engine(tparams, tcfg, max_slots=4, page_size=8, chunk=8,
                                window=4, spec_k=0, prefix_cache=False, device="cpu")
    want, _ = serve_prompts(cold, prompts, 8)
    assert [first, *out.values()] == [want[i] for i in range(4)]
