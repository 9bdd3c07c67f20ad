"""The port's int8 KV pages against dora_tpu's, on the CPU.

* ``kv_quant_rows`` / ``kv_dequant`` equal the JAX package's exactly;
* the three attention sublayers' plain versions in their int8-KV form
  against the JAX kernels run in Pallas interpret mode, on the geometries
  of tests/test_kv_int8.py (head_dim 16, page 8). Outputs within 1e-4
  relative plus 2e-5 of the largest magnitude (f32 sums taken in another
  order, as tests/test_torch_decode_block.py); written int8 bytes within 1
  LSB, the share that differs printed (the f32 K/V differ by summation
  order, so a value on a rounding boundary may land one step apart); their
  scales within 1e-6 relative; every other value and scale entry
  bit-unchanged;
* the port's int8 engine emits exactly the JAX int8 engine's greedy tokens
  at window 1 and 8 and spec_k 0 and 2 (the JAX engine is run once, at
  window 8 without speculation: its own tests hold its int8 tokens equal at
  every (window, spec_k)), holds as many pages as the JAX engine in the
  same byte budget, and its prefix cache shares quantized pages.
"""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dora_tpu.models import layers as JL
from dora_tpu.ops import decode_block as JDB
from dora_tpu.ops.int8_matmul import quantize_int8 as jquant
from dora_tpu_torch.ops import decode_block as TDB

_D, _H, _KV, _HD, _S, _PAGE = 64, 4, 2, 16, 64, 8


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want):
    want = np.asarray(want)
    atol = 2e-5 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4, atol=atol)


def test_kv_quant_rows_and_dequant_match_jax_exactly():
    """Random rows, an all-zero row (the scale floor) and rows whose values
    sit exactly on half steps (round half to even)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 2, 8, 16)).astype(np.float32)
    x[0, 0, 0] = 0.0
    x[1, 1, 2] = np.arange(16, dtype=np.float32) - 7.5  # amax 8.5 / 127 steps
    x[2, 0, 3, :4] = [127.0, 0.5, 1.5, -2.5]
    q, s = TDB.kv_quant_rows(torch.from_numpy(x))
    jq, js = JDB.kv_quant_rows(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.shape == x.shape[:-1]
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert float(s[0, 0, 0]) == np.float32(1e-8)
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = TDB.kv_dequant(q, s, dt).float().numpy()
        want = np.asarray(JDB.kv_dequant(jq, js, jdt).astype(jnp.float32))
        np.testing.assert_array_equal(got, want)


def _weights(rng):
    nw = rng.standard_normal(_D).astype(np.float32)
    wqkv = jquant(jnp.asarray(rng.standard_normal((_D, (_H + 2 * _KV) * _HD)), jnp.float32))
    wo = jquant(jnp.asarray(rng.standard_normal((_H * _HD, _D)), jnp.float32))
    bqkv = rng.standard_normal((_H + 2 * _KV) * _HD).astype(np.float32)
    return nw, wqkv, bqkv, wo


def _quant_pools(rng, pages):
    kf = rng.standard_normal((pages, _KV, _PAGE, _HD)).astype(np.float32) * 0.1
    vf = rng.standard_normal((pages, _KV, _PAGE, _HD)).astype(np.float32) * 0.1
    kq, ks = JDB.kv_quant_rows(jnp.asarray(kf))
    vq, vs = JDB.kv_quant_rows(jnp.asarray(vf))
    return [np.asarray(a) for a in (kq, vq, ks, vs)]


def _args(nw, wqkv, bqkv, wo, x, cosr, sinr, pools, tail, torch_side: bool):
    """The positional operands of an attention sublayer for one side."""
    conv = _t if torch_side else jnp.asarray
    kq, vq, ks, vs = [conv(np.array(a)) for a in pools]
    return (conv(x), conv(nw), conv(wqkv["int8"]), conv(wqkv["scale"]), conv(bqkv),
            conv(cosr), conv(sinr), kq, vq, conv(wo["int8"]), conv(wo["scale"]),
            *[conv(t) if not isinstance(t, int) else t for t in tail], ks, vs)


def _assert_pools(got, want, before, written, what):
    """Written rows: int8 bytes within 1 LSB, scales within 1e-6 relative;
    everything else bit-unchanged (tables here never name the null page)."""
    mask = np.zeros(before[2].shape, bool)
    for pg, off in written:
        mask[pg, :, off] = True
    diff = n = 0
    for g, w, b in zip(got[:2], want[:2], before[:2]):
        g, w = np.asarray(g).astype(np.int32), np.asarray(w).astype(np.int32)
        assert np.abs(g[mask] - w[mask]).max() <= 1, what
        diff += int((g[mask] != w[mask]).sum())
        n += g[mask].size
        np.testing.assert_array_equal(g[~mask], b[~mask])
    for g, w, b in zip(got[2:], want[2:], before[2:]):
        np.testing.assert_allclose(np.asarray(g)[mask], np.asarray(w)[mask], rtol=1e-6, atol=0)
        np.testing.assert_array_equal(np.asarray(g)[~mask], b[~mask])
    print(f"{what}: {diff} of {n} written int8 bytes one step from the JAX kernel's")


def test_paged_batch_int8kv_plain_matches_pallas():
    """One decode row per stream at positions covering both halves of an
    8-row scale group and a page boundary."""
    rng = np.random.default_rng(1)
    b, positions = 4, [9, 30, 7, 16]
    npages = _S // _PAGE
    nw, wqkv, bqkv, wo = _weights(rng)
    pools = _quant_pools(rng, 1 + b * npages)
    bt = np.stack([1 + i * npages + np.arange(npages) for i in range(b)]).astype(np.int32)
    x = rng.standard_normal((b, _D)).astype(np.float32)
    cos_t, sin_t = JL.rope_table(_S, _HD)
    pos = np.asarray(positions, np.int32)
    cosr, sinr = (np.asarray(a) for a in JDB.rope_rows_at(cos_t, sin_t, jnp.asarray(pos)))
    kw = dict(heads=_H, kv_heads=_KV, head_dim=_HD)
    want = JDB.attention_paged_batch_step(
        *_args(nw, wqkv, bqkv, wo, x, cosr, sinr, pools, (pos, bt), False), **kw)
    got = TDB.attention_paged_batch_step(
        *_args(nw, wqkv, bqkv, wo, x, cosr, sinr, pools, (pos, bt), True), **kw)
    assert len(got) == 5 and got[1].dtype == torch.int8
    _close(got[0].numpy(), want[0])
    written = [(int(bt[i, p // _PAGE]), p % _PAGE) for i, p in enumerate(positions)]
    _assert_pools(got[1:], want[1:], pools, written, "batch")


def test_paged_chunk_int8kv_plain_matches_pallas():
    """A 16-row prefill chunk (two whole pages) with 16 rows of prior
    context streaming through the table."""
    rng = np.random.default_rng(2)
    m, pos = 16, 16
    npages = _S // _PAGE
    nw, wqkv, bqkv, wo = _weights(rng)
    pools = _quant_pools(rng, 1 + npages)
    bt = np.arange(1, 1 + npages, dtype=np.int32)
    x = rng.standard_normal((m, _D)).astype(np.float32)
    cos_t, sin_t = JL.rope_table(_S, _HD)
    cosr, sinr = (np.asarray(a) for a in JDB.rope_rows(cos_t, sin_t, pos, m))
    kw = dict(heads=_H, kv_heads=_KV, head_dim=_HD)
    want = JDB.attention_paged_chunk_step(
        *_args(nw, wqkv, bqkv, wo, x, cosr, sinr, pools, (pos, bt), False), **kw)
    got = TDB.attention_paged_chunk_step(
        *_args(nw, wqkv, bqkv, wo, x, cosr, sinr, pools, (pos, bt), True), **kw)
    _close(got[0].numpy(), want[0])
    written = [(int(bt[r // _PAGE]), r % _PAGE) for r in range(pos, pos + m)]
    _assert_pools(got[1:], want[1:], pools, written, "chunk")


def test_paged_spec_int8kv_plain_matches_pallas():
    """B verify chunks of m = 5; position 6 crosses a page and a scale-group
    boundary."""
    rng = np.random.default_rng(3)
    b, m, positions = 4, 5, [9, 30, 6, 16]
    npages = _S // _PAGE
    nw, wqkv, bqkv, wo = _weights(rng)
    pools = _quant_pools(rng, 1 + b * npages)
    bt = np.stack([1 + i * npages + np.arange(npages) for i in range(b)]).astype(np.int32)
    x = rng.standard_normal((b * m, _D)).astype(np.float32)
    cos_t, sin_t = JL.rope_table(_S, _HD)
    pos = np.asarray(positions, np.int32)
    flat = (pos[:, None] + np.arange(m)[None, :]).reshape(-1)
    cosr, sinr = (np.asarray(a) for a in JDB.rope_rows_at(cos_t, sin_t, jnp.asarray(flat)))
    kw = dict(heads=_H, kv_heads=_KV, head_dim=_HD, m=m)
    want = JDB.attention_paged_spec_step(
        *_args(nw, wqkv, bqkv, wo, x, cosr, sinr, pools, (pos, bt), False), **kw)
    got = TDB.attention_paged_spec_step(
        *_args(nw, wqkv, bqkv, wo, x, cosr, sinr, pools, (pos, bt), True), **kw)
    _close(got[0].numpy(), want[0])
    written = [(int(bt[i, r // _PAGE]), r % _PAGE)
               for i, p in enumerate(positions) for r in range(p, p + m)]
    _assert_pools(got[1:], want[1:], pools, written, "spec")


def test_wrappers_refuse_half_a_scale_pair_and_fp_pools():
    x = torch.zeros((1, _D))
    pools = torch.zeros((2, _KV, _PAGE, _HD))
    sc = torch.zeros((2, _KV, _PAGE))
    args = (x, None, None, None, None, None, None, pools, pools, None, None,
            torch.zeros(1, dtype=torch.int32), torch.zeros((1, 2), dtype=torch.int32))
    kw = dict(heads=_H, kv_heads=_KV, head_dim=_HD)
    with pytest.raises(ValueError, match="both or neither"):
        TDB.attention_paged_batch_step(*args, sc, None, **kw)
    with pytest.raises(ValueError, match="int8 pools"):
        TDB.attention_paged_batch_step(*args, sc, sc, **kw)


# ---------------------------------------------------------------------------
# the engine with int8 KV pages
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(jax cfg, jax quantized params, port cfg, port params) on the same
    weights of a tiny random Qwen2 checkpoint (tests/test_kv_int8.py's)."""
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
    path = tmp_path_factory.mktemp("qwen2-torch-kvint8")
    Qwen2ForCausalLM(config).eval().save_pretrained(path, safe_serialization=True)
    cfg, params = jq.load(path, max_seq=64)
    os.environ["DORA_INT8_DECODE"] = "1"
    try:
        qparams = jq.quantize_decode(params, cfg)
    finally:
        os.environ.pop("DORA_INT8_DECODE", None)
    tcfg, _ = tq.load(path, max_seq=64, device="cpu")
    return cfg, qparams, tcfg, tq.params_from_jax(qparams, device="cpu")


def _run_sequential(engine, prompts, max_new):
    out: dict[str, list[int]] = {}
    for i, p in enumerate(prompts):
        engine.submit(f"r{i}", p, max_new)
        while engine.active or engine.prefilling:
            for rid, tok, _done in engine.step():
                out.setdefault(rid, []).append(tok)
    return out


def _prompts(vocab):
    """tests/test_kv_int8.py's warm and fresh prompts (multi-chunk ones
    included)."""
    rng = np.random.default_rng(11)
    warm = [rng.integers(0, vocab, size=n).tolist() for n in (3, 20)]
    fresh = [rng.integers(0, vocab, size=n).tolist() for n in (5, 33, 2)]
    return warm + fresh


@pytest.fixture(scope="module")
def jax_int8_tokens(both):
    from dora_tpu.models.hf import qwen2 as jq

    cfg, qparams, _, _ = both
    engine = jq.make_paged_engine(qparams, cfg, max_slots=4, page_size=8, chunk=16,
                                  window=8, spec_k=0, kv_int8=True)
    assert engine.kv_dtype == "int8"
    return _run_sequential(engine, _prompts(cfg.vocab), 6)


@pytest.mark.parametrize("window", [1, 8])
@pytest.mark.parametrize("spec_k", [0, 2])
def test_port_int8_engine_matches_jax(both, jax_int8_tokens, window, spec_k):
    from dora_tpu_torch.models.hf import qwen2 as tq

    _, _, tcfg, tparams = both
    engine = tq.make_paged_engine(tparams, tcfg, max_slots=4, page_size=8, chunk=16,
                                  window=window, spec_k=spec_k, kv_int8=True,
                                  device="cpu")
    lp = engine.pools["0"]
    assert engine.kv_dtype == "int8" and lp["k"].dtype == torch.int8
    assert lp["ks"].shape == lp["k"].shape[:3] and lp["ks"].dtype == torch.float32
    got = _run_sequential(engine, _prompts(tcfg.vocab), 6)
    assert got == jax_int8_tokens
    engine.check_invariants()


def test_same_page_count_and_capacity_in_the_fp_byte_budget(both):
    """The int8 pool takes as many pages as the JAX engine's in the fp
    pool's byte budget (scale planes included), never more bytes, and
    admits >= 1.8x the streams through can_admit/submit."""
    from dora_tpu.models.hf import qwen2 as jq
    from dora_tpu_torch.models.hf import qwen2 as tq

    cfg, qparams, tcfg, tparams = both
    plen, max_new = 4, 24

    def admitted(kv8: bool):
        eng = tq.make_paged_engine(tparams, tcfg, max_slots=512, page_size=8, chunk=8,
                                   kv_int8=kv8, device="cpu")
        n = 0
        while n < 512 and eng.can_admit(plen, max_new):
            eng.submit(f"c{n}", list(range(plen)), max_new)
            n += 1
        return eng, n

    fp, n_fp = admitted(False)
    q8, n_q8 = admitted(True)
    jeng = jq.make_paged_engine(qparams, cfg, max_slots=4, page_size=8, chunk=8, kv_int8=True)
    assert q8.allocator.num_pages == jeng.allocator.num_pages
    assert q8.kv_pool_bytes() == jeng.kv_pool_bytes()
    assert 0.9 * fp.kv_pool_bytes() <= q8.kv_pool_bytes() <= fp.kv_pool_bytes()
    assert n_q8 >= 1.8 * n_fp, (n_q8, n_fp)
    for kv8 in (False, True):
        assert tq.page_pool_bytes(tcfg, 8, torch.float32, kv_int8=kv8) == \
            jq.page_pool_bytes(cfg, 8, kv_int8=kv8)
    # Qwen2-1.5B on the card: the 512 bf16 pages' budget holds 992 int8 pages
    big = tq.Qwen2Config.qwen2_1_5b()
    assert 512 * tq.page_pool_bytes(big, 16) // tq.page_pool_bytes(big, 16, kv_int8=True) == 992


def test_prefix_cache_shares_quantized_pages(both, jax_int8_tokens):
    """Cache-hit admissions map the quantized pages (values and scale planes
    under one page id): warm tokens equal the cold run's, one hit, one
    miss."""
    from dora_tpu_torch.models.hf import qwen2 as tq

    _, _, tcfg, tparams = both
    rng = np.random.default_rng(5)
    tmpl = rng.integers(0, tcfg.vocab, size=24).tolist()
    tails = [rng.integers(0, tcfg.vocab, size=n).tolist() for n in (2, 3)]
    prompts = [tmpl + tails[0], tmpl + tails[1]]

    def build(cache: bool):
        return tq.make_paged_engine(tparams, tcfg, max_slots=4, page_size=8, chunk=16,
                                    window=8, prefix_cache=cache, kv_int8=True,
                                    device="cpu")

    cold = _run_sequential(build(False), prompts, 6)
    eng = build(True)
    warm = _run_sequential(eng, prompts, 6)
    assert cold == warm
    assert eng.prefix_cache.hits == 1 and eng.prefix_cache.misses == 1
    assert eng.prefix_cache.hit_tokens == 24
    eng.check_invariants()
