"""The port's multi-tenant LoRA against dora_tpu's, on the CPU.

* ``lora_gather_matmul_plain`` against the JAX package's eager oracle
  ``lora_gather_matmul_ref`` in f32, within 1e-5 relative plus 1e-6 of the
  largest magnitude (two products summed in another order), also on the
  shapes the grouped kernel takes apart (one adapter, distinct adapters,
  all slot 0, ranks 1 / 12 / 256, width 100); slot-0 rows exactly zero.
  (The Pallas kernel itself is not the oracle: it differs from
  ``lora_gather_matmul_ref`` bit for bit, tests/test_lora.py:54.)
* ``AdapterPool`` against the JAX pool on identical operation sequences:
  slots, refcounts, LRU eviction, loads, evictions, stats and the stack's
  contents;
* per-tenant identity on the tiny Qwen2 with tests/test_lora.py's
  two-tenant catalog: each tenant's and the base stream's greedy tokens
  equal the JAX engine's, at window 1 and 8 and spec_k 0 and 2 (the JAX
  engine is run once, at window 8 without speculation: its own tests hold
  its tokens equal at every (window, spec_k)), also on int8 KV pages; and
  the base stream equals an engine without a catalog;
* the prefix cache never shares pages across tenants, and admission parks
  a tenant whose adapter cannot be made resident until a slot unpins.
"""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dora_tpu_torch.ops import lora as LO


def test_plain_matches_the_eager_oracle_and_base_rows_are_zero():
    from dora_tpu.ops.lora import lora_gather_matmul_ref

    rng = np.random.default_rng(0)
    rows, dim, rank, slots = 9, 48, 8, 3
    x = rng.normal(size=(rows, dim)).astype(np.float32)
    a = (rng.normal(size=(slots, dim, rank)) * 0.3).astype(np.float32)
    b = (rng.normal(size=(slots, rank, dim)) * 0.3).astype(np.float32)
    a[0] = 0.0
    b[0] = 0.0
    groups = np.asarray([0, 1, 2, 1, 0, 2, 2, 1, 0], np.int32)
    want = np.asarray(lora_gather_matmul_ref(jnp.asarray(x), jnp.asarray(groups),
                                             jnp.asarray(a), jnp.asarray(b)))
    got = LO.lora_gather_matmul(torch.from_numpy(x), torch.from_numpy(groups),
                                torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float32 and got.shape == (rows, dim)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-6 * float(np.abs(want).max()))
    assert not got[torch.from_numpy(groups) == 0].any()
    # a layer's strided slice of an [S, L, D, r] stack gives the same rows
    a4 = torch.from_numpy(np.stack([a, a * 2], axis=1))
    b4 = torch.from_numpy(np.stack([b, b], axis=1))
    sliced = LO.lora_gather_matmul(torch.from_numpy(x), torch.from_numpy(groups),
                                   a4[:, 0], b4[:, 0])
    assert torch.equal(sliced, got)


#: (rows, width, rank, slots, ids): the shapes the grouped kernel takes apart
#: (tests/test_torch_kernels_emulated.py): one adapter for every row, every
#: row its own adapter, every row on slot 0, ranks 1, 12 and 256, a width
#: off 16 (the oracle takes no empty batch: no rows is held to the plain
#: version there)
GROUPED = {
    "one_adapter": (80, 96, 12, 5, "one"),
    "distinct": (9, 96, 12, 10, "distinct"),
    "all_base": (12, 96, 12, 5, "base"),
    "rank1": (7, 96, 1, 5, "mixed"),
    "rank12": (33, 96, 12, 5, "mixed"),
    "rank256": (70, 96, 256, 5, "mixed"),
    "width100": (19, 100, 12, 5, "mixed"),
}


@pytest.mark.parametrize("case", sorted(GROUPED))
def test_plain_matches_the_eager_oracle_on_grouped_shapes(case):
    """The port's twin against ``lora_gather_matmul_ref`` on inputs made from
    one numpy seed, in f32, within 1e-5 relative plus 1e-6 of the largest
    magnitude (two products summed in another order); slot-0 rows exactly
    zero."""
    from dora_tpu.ops.lora import lora_gather_matmul_ref

    rows, dim, rank, slots, ids = GROUPED[case]
    rng = np.random.default_rng(11)
    x = rng.normal(size=(rows, dim)).astype(np.float32)
    a = (rng.normal(size=(slots, dim, rank)) * 0.3).astype(np.float32)
    b = (rng.normal(size=(slots, rank, dim)) * 0.3).astype(np.float32)
    a[0] = 0.0
    b[0] = 0.0
    groups = {"one": np.full(rows, slots - 1), "distinct": rng.permutation(rows) + 1,
              "base": np.zeros(rows), "mixed": rng.integers(0, slots, size=rows)}[ids]
    groups = groups.astype(np.int32)
    want = np.asarray(lora_gather_matmul_ref(jnp.asarray(x), jnp.asarray(groups),
                                             jnp.asarray(a), jnp.asarray(b)))
    got = LO.lora_gather_matmul(torch.from_numpy(x), torch.from_numpy(groups),
                                torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == want.shape == (rows, dim)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-6 * float(np.abs(want).max()))
    assert not got[torch.from_numpy(groups) == 0].any()


# ---------------------------------------------------------------------------
# the adapter pool
# ---------------------------------------------------------------------------


def _loader_value(name):
    return sum(ord(c) for c in name) % 97


def _pools(max_resident, known=None):
    from dora_tpu.models.lora_pool import AdapterPool as JPool
    from dora_tpu_torch.models.lora_pool import AdapterPool as TPool

    jp = JPool(lambda n: jnp.asarray(_loader_value(n), jnp.int32),
               jnp.asarray(0, jnp.int32), max_resident=max_resident, known=known)
    tp = TPool(lambda n: torch.tensor(_loader_value(n), dtype=torch.int32),
               torch.tensor(0, dtype=torch.int32), max_resident=max_resident, known=known)
    return jp, tp


def _same(jp, tp):
    assert tp.stats() == jp.stats()
    assert tp.resident_bytes() == jp.resident_bytes()
    np.testing.assert_array_equal(tp.state().numpy(), np.asarray(jp.state()))
    jp.check_invariants()
    tp.check_invariants()


@pytest.mark.parametrize("max_resident", (1, 2, 3))
def test_adapter_pool_matches_jax_on_the_same_operations(max_resident):
    """tests/test_lora.py's refcount / LRU / fits scenarios, then a seeded
    run of acquire / release over more tenants than slots."""
    jp, tp = _pools(max_resident, known={"a", "b", "c", "d"})
    ops = [("acquire", "a"), ("acquire", "b"), ("acquire", "c"), ("release", "a"),
           ("acquire", "c"), ("acquire", "b"), ("release", "b"), ("release", "b"),
           ("acquire", None), ("release", None), ("release", "zz")]
    rng = np.random.default_rng(max_resident)
    names = ["a", "b", "c", "d", None]
    ops += [(("acquire", "release")[int(rng.integers(2))], names[int(rng.integers(5))])
            for _ in range(60)]
    for op, name in ops:
        for q in ("slot_of", "has", "fits"):
            assert getattr(tp, q)(name) == getattr(jp, q)(name), (op, name, q)
        assert getattr(tp, op)(name) == getattr(jp, op)(name), (op, name)
        _same(jp, tp)
    assert not tp.has("nope") and tp.has(None)
    assert tp.evictions > 0


def test_adapter_pool_keeps_slot_zero_zero_and_writes_dict_slots_in_place():
    from dora_tpu_torch.models.lora_pool import AdapterPool

    template = {"a": torch.zeros((2, 4, 3)), "b": torch.zeros((2, 3, 4))}
    pool = AdapterPool(lambda n: {"b": torch.full((2, 3, 4), float(len(n))),
                                  "a": torch.full((2, 4, 3), -float(len(n)))},
                       template, max_resident=2)
    stack = pool.state()
    assert pool.acquire("xy") == 2 and pool.acquire("xyz") == 1
    assert pool.state() is stack and stack["a"].shape == (3, 2, 4, 3)
    assert not stack["a"][0].any() and not stack["b"][0].any()
    assert float(stack["b"][2, 0, 0, 0]) == 2.0 and float(stack["a"][1, 0, 0, 0]) == -3.0
    assert pool.adapter_bytes() == (24 + 24) * 4


# ---------------------------------------------------------------------------
# the engine with adapters
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lora_qwen2(tmp_path_factory):
    """Tiny random Qwen2 (jax and port params on the same weights) and
    tests/test_lora.py's catalog of two tenants whose deltas flip greedy
    tokens."""
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
    path = tmp_path_factory.mktemp("qwen2-torch-lora")
    Qwen2ForCausalLM(config).eval().save_pretrained(path, safe_serialization=True)
    lora_dir = tmp_path_factory.mktemp("torch-adapters")
    rng = np.random.default_rng(7)
    for name, scale, rank in (("ta", 0.3, 4), ("tb", 0.5, 8)):
        np.savez(
            lora_dir / f"{name}.npz",
            **{f"a_{i}": rng.normal(size=(64, rank)).astype(np.float32) * scale
               for i in range(2)},
            **{f"b_{i}": rng.normal(size=(rank, 64)).astype(np.float32) * scale
               for i in range(2)},
        )
    cfg, params = jq.load(str(path), max_seq=64)
    os.environ["DORA_INT8_DECODE"] = "1"
    try:
        qparams = jq.quantize_decode(params, cfg)
    finally:
        os.environ.pop("DORA_INT8_DECODE", None)
    tcfg, _ = tq.load(str(path), max_seq=64, device="cpu")
    return cfg, qparams, tcfg, tq.params_from_jax(qparams, device="cpu"), str(lora_dir)


def _serve_all(engine, work, max_new=8):
    """work: (key, ids, adapter) triples, admitted in order as they fit.
    Returns key -> tokens."""
    out: dict[str, list[int]] = {k: [] for k, _, _ in work}
    backlog = list(work)
    active: set[str] = set()
    while backlog or active:
        while backlog and engine.can_admit(len(backlog[0][1]), max_new, backlog[0][2]):
            key, ids, ad = backlog.pop(0)
            active.add(key)
            engine.submit(key, ids, max_new, adapter=ad)
        for key, tok, done in engine.step():
            out[key].append(int(tok))
            if done:
                active.discard(key)
    return out


_PROMPTS = {"ta": [3, 5, 7], "tb": [11, 2], None: [9, 4]}
_WORK = [("ta", _PROMPTS["ta"], "ta"), ("tb", _PROMPTS["tb"], "tb"),
         ("base", _PROMPTS[None], None)]


@pytest.fixture(scope="module")
def jax_tenant_tokens(lora_qwen2):
    from dora_tpu.models.hf import qwen2 as jq

    cfg, qparams, _, _, lora_dir = lora_qwen2
    engine = jq.make_paged_engine(qparams, cfg, max_slots=4, page_size=8, chunk=8,
                                  window=8, spec_k=0, lora_dir=lora_dir)
    return _serve_all(engine, _WORK)


@pytest.mark.parametrize("window,spec_k", [(1, 0), (8, 0), (1, 2), (8, 2)])
def test_port_per_tenant_tokens_match_jax(lora_qwen2, jax_tenant_tokens, window, spec_k):
    from dora_tpu_torch.models.hf import qwen2 as tq

    _, _, tcfg, tparams, lora_dir = lora_qwen2

    def engine(**kw):
        return tq.make_paged_engine(tparams, tcfg, max_slots=4, page_size=8, chunk=8,
                                    window=window, spec_k=spec_k, device="cpu", **kw)

    mixed_engine = engine(lora_dir=lora_dir)
    assert mixed_engine.lora.stats()["max_resident"] == 8
    assert mixed_engine.lora.state()["a"].shape == (9, 2, 64, 8)  # rank 4 padded to 8
    mixed = _serve_all(mixed_engine, _WORK)
    assert mixed == jax_tenant_tokens
    mixed_engine.check_invariants()
    mixed_engine.lora.check_invariants()
    assert mixed_engine.lora.streams_by_adapter() == {"ta": 0, "tb": 0}
    # the adapters steer: some tenant's stream differs from the base one
    plain = _serve_all(engine(), [("base", _PROMPTS[None], None)])
    assert mixed["base"] == plain["base"]
    assert any(_serve_all(engine(), [(t, _PROMPTS[t], None)])[t] != mixed[t]
               for t in ("ta", "tb"))
    # int8 KV pages beside the adapters: the same tokens on this model
    assert _serve_all(engine(lora_dir=lora_dir, kv_int8=True), _WORK) == jax_tenant_tokens


def test_prefix_cache_never_shares_pages_across_tenants(lora_qwen2):
    """The same two-page prompt: a second stream of the same tenant maps
    the first's pages; another tenant and the base model map none."""
    from dora_tpu_torch.models.hf import qwen2 as tq

    _, _, tcfg, tparams, lora_dir = lora_qwen2
    engine = tq.make_paged_engine(tparams, tcfg, max_slots=4, page_size=8, chunk=8,
                                  prefix_cache=True, lora_dir=lora_dir, device="cpu")
    prompt = list(range(3, 20))  # two full pages and one token
    pc = engine.prefix_cache
    first = _serve_all(engine, [("a0", prompt, "ta")], max_new=4)
    _serve_all(engine, [("a1", prompt, "ta")], max_new=4)
    assert (pc.hits, pc.hit_tokens) == (1, 16)
    got = _serve_all(engine, [("b0", prompt, "tb"), ("c0", prompt, None)], max_new=4)
    assert (pc.hits, pc.hit_tokens, pc.misses) == (1, 16, 3)
    assert got["b0"] != first["a0"] or got["c0"] != first["a0"]
    engine.check_invariants()


def test_admission_parks_a_tenant_until_its_adapter_can_be_resident(lora_qwen2):
    """One resident slot: while tenant ta's stream pins it, tb cannot be
    admitted ("adapter_residency"); serve_prompts parks tb at the head of
    the line and admits it when ta's stream ends, and both streams equal
    their solo runs."""
    from dora_tpu_torch.models.hf import qwen2 as tq
    from dora_tpu_torch.nodehub.llm_server import serve_prompts

    _, _, tcfg, tparams, lora_dir = lora_qwen2

    def engine():
        return tq.make_paged_engine(tparams, tcfg, max_slots=4, page_size=8, chunk=8,
                                    lora_dir=lora_dir, lora_max_resident=1, device="cpu")

    eng = engine()
    eng.submit("x", _PROMPTS["ta"], 4, adapter="ta")
    assert not eng.can_admit(2, 4, "tb") and eng.can_admit(2, 4, None)
    assert eng.admit_blocker(2, 4, "tb") == "adapter_residency"
    assert eng.admit_blocker(2, 4, "ta") is None
    assert not eng.fits(2, 4, "nope") and eng.admit_blocker(2, 4, "nope") == "capacity"

    eng = engine()
    order = []
    out, _ = serve_prompts(eng, [_PROMPTS["ta"], _PROMPTS["tb"], _PROMPTS[None]], 6,
                           on_token=lambda i, t, d: order.append(i),
                           adapters=["ta", "tb", None])
    assert order.index(1) > max(j for j, i in enumerate(order) if i == 0)
    assert eng.lora.evictions == 1 and eng.lora.loads == 2
    for i, t in ((0, "ta"), (1, "tb")):
        solo, _ = serve_prompts(engine(), [_PROMPTS[t]], 6, adapters=[t])
        assert out[i] == solo[0]
    with pytest.raises(ValueError, match="can never fit"):
        serve_prompts(engine(), [_PROMPTS["ta"]], 6, adapters=["nope"])
