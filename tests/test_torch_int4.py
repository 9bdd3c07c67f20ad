"""The port's int4 weights against dora_tpu's, on the CPU.

* ``ops/int4.py``: ``quantize_int4`` (groups of 128, of gcd(K, 128) = 32 at
  K 160, values on half steps), ``unpack_grouped`` (biased and not),
  ``dequantize_int4`` and ``quantize_tree_int4`` (fused ``wqkv`` and
  ``w_gateup``, biases, sidecars) give the JAX package's bytes exactly;
* the int4 plain versions of kernels 1-5 and 8-10 against the JAX package's
  Pallas kernels, which take the int4 branch on uint8 weights, run in
  interpret mode as tests/test_ops.py runs them, on weights quantized by the
  JAX package from seeded numpy normals of std 1 / sqrt(K): K 256 on every product (two groups
  of 128), ``mlp_step`` with the residual on and off, kernels 3-5 with fp
  and int8 KV pages. Outputs within 1e-4 relative plus 2e-5 of the largest
  magnitude (f32 sums of the same exact products taken in another order, as
  tests/test_torch_decode_block.py); argmax tokens exact; written int8 KV
  bytes within 1 LSB, as tests/test_torch_kv_int8.py, and their scales
  within 1e-5 relative (the reference's bias fold, q'x - 8 sum(x) per group,
  subtracts two sums several times larger than the K/V values, so their f32
  order errors are several times int8's, whose scales hold 1e-6);
* ``layers.matmul``'s int4 fallback at 32 and 33 rows, with and without the
  bf16 sidecar, against the JAX package's;
* the wrappers and the engine factories refuse a group the kernels do not
  take (not a multiple of 128) on the card, and the CPU serves it.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dora_tpu.models import layers as JL
from dora_tpu.ops import decode_block as JDB
from dora_tpu.ops import int4 as J4
from dora_tpu_torch.models import layers as TL
from dora_tpu_torch.ops import decode_block as TDB
from dora_tpu_torch.ops import int4 as T4

D, H, KV, HD, F, S, PAGE = 256, 4, 2, 64, 256, 64, 8


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want):
    want = np.asarray(want)
    atol = 2e-5 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4, atol=atol)


def _same(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            _same(got[k], want[k])
            continue
        w = np.asarray(want[k])
        g = got[k]
        if w.dtype.name == "bfloat16":
            assert g.dtype == torch.bfloat16, k
            np.testing.assert_array_equal(g.view(torch.int16).numpy(), w.view(np.int16))
        else:
            assert str(g.dtype).endswith(w.dtype.name), (k, g.dtype, w.dtype)
            np.testing.assert_array_equal(g.numpy(), w)


# ---------------------------------------------------------------------------
# the number format
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k,n", [(256, 384), (160, 48)])
def test_quantize_int4_gives_jax_bytes(k, n):
    """Two groups of 128, and K 160 (five groups of gcd(160, 128) = 32); the
    first group holds values on half steps of its scale (max 7: scale 1), so
    round half to even decides them."""
    rng = np.random.default_rng(k)
    w = rng.standard_normal((k, n)).astype(np.float32)
    w[:8, 0] = [7.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5]
    w[8:32, 0] = 0.25
    want = J4.quantize_int4(jnp.asarray(w), keep_bf16=True)
    got = T4.quantize_int4(torch.from_numpy(w), keep_bf16=True)
    g = T4.group_for(k)
    assert g == J4.group_for(k) == (128 if k == 256 else 32)
    assert got["int4"].shape == (k // 2, n) and got["int4"].dtype == torch.uint8
    assert got["gscale"].shape == (k // g, n) and got["gscale"].dtype == torch.float32
    _same(got, want)
    for biased in (False, True):
        np.testing.assert_array_equal(
            T4.unpack_grouped(got["int4"], k // g, torch.float32, biased=biased).numpy(),
            np.asarray(J4.unpack_grouped(want["int4"], k // g, jnp.float32, biased=biased)))
    np.testing.assert_array_equal(T4.dequantize_int4(got).numpy(),
                                  np.asarray(J4.dequantize_int4(want)))
    assert T4.dequantize_int4(got, torch.bfloat16).dtype == torch.bfloat16


def test_quantize_tree_int4_fuses_as_jax():
    """A block with q/k/v (and their biases) and gate/up: fused ``wqkv`` and
    ``w_gateup`` with the concatenated bias, ``wo`` and ``w_down`` alone, the
    norm untouched, an already-quantized dict passed through."""
    rng = np.random.default_rng(0)

    def w(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    block = {"attn_norm": w(D), "wq": w(D, H * HD), "wk": w(D, KV * HD), "wv": w(D, KV * HD),
             "bq": w(H * HD), "bk": w(KV * HD), "bv": w(KV * HD), "wo": w(H * HD, D),
             "w_gate": w(D, F), "w_up": w(D, F), "w_down": w(F, D)}
    want = J4.quantize_tree_int4({"0": {k: jnp.asarray(v) for k, v in block.items()}})
    got = T4.quantize_tree_int4({"0": {k: torch.from_numpy(v) for k, v in block.items()}})
    assert set(got["0"]) == {"attn_norm", "wqkv", "bqkv", "wo", "w_gateup", "w_down"}
    assert got["0"]["wqkv"]["int4"].shape == (D // 2, (H + 2 * KV) * HD)
    _same(got, want)
    q = got["0"]["wo"]
    assert T4.quantize_tree_int4(q) is q


# ---------------------------------------------------------------------------
# the kernels' int4 plain versions against the Pallas kernels
# ---------------------------------------------------------------------------


def _q4(rng, k, n):
    """One int4 weight of std 1 / sqrt(K) (attention scores of O(1), so the
    softmax is not one-hot), quantized by the JAX package: (jax pair, port
    pair)."""
    w = rng.standard_normal((k, n)) / np.sqrt(k)
    q = J4.quantize_int4(jnp.asarray(w, jnp.float32))
    return (q["int4"], q["gscale"]), (_t(q["int4"]), _t(q["gscale"]))


@pytest.mark.parametrize("m,bias,residual", [(1, True, True), (5, False, True), (3, True, False)])
def test_mlp_step_int4_matches_pallas(m, bias, residual):
    rng = np.random.default_rng(m)
    x = rng.standard_normal((m, D)).astype(np.float32)
    nw = rng.standard_normal(D).astype(np.float32)
    (jgu, jsgu), (tgu, tsgu) = _q4(rng, D, 2 * F)
    (jd, jsd), (td, tsd) = _q4(rng, F, D)
    b = rng.standard_normal(2 * F).astype(np.float32) if bias else np.zeros(2 * F, np.float32)
    want = JDB.mlp_step(jnp.asarray(x), jnp.asarray(nw), jgu, jsgu, jnp.asarray(b), jd, jsd,
                        residual=residual)
    got = TDB.mlp_step(_t(x), _t(nw), tgu, tsgu, _t(b) if bias else None, td, tsd,
                       residual=residual)
    assert got.shape == (m, D) and got.dtype == torch.float32
    _close(got.numpy(), want)


@pytest.mark.parametrize("m,vocab", [(1, 256), (5, 300), (16, 2100)])
def test_lm_head_argmax_int4_matches_pallas(m, vocab):
    rng = np.random.default_rng(m + vocab)
    x = rng.standard_normal((m, D)).astype(np.float32)
    nw = rng.standard_normal(D).astype(np.float32)
    (jw, js), (tw, ts) = _q4(rng, D, vocab)
    jtok, jval = JDB.lm_head_argmax(jnp.asarray(x), jnp.asarray(nw), jw, js, return_val=True)
    ttok, tval = TDB.lm_head_argmax(_t(x), _t(nw), tw, ts, return_val=True)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    _close(tval.numpy(), jval)


def _weights(rng):
    """Sublayer weights: (jax, port) tuples of (norm_w, wqkv, sqkv, bqkv)
    and (wo, swo), int4 at K 256."""
    (jqkv, jsqkv), (tqkv, tsqkv) = _q4(rng, D, (H + 2 * KV) * HD)
    (jo, jso), (to, tso) = _q4(rng, H * HD, D)
    nw = rng.standard_normal(D).astype(np.float32)
    bqkv = rng.standard_normal((H + 2 * KV) * HD).astype(np.float32)
    return (((jnp.asarray(nw), jqkv, jsqkv, jnp.asarray(bqkv)), (jo, jso)),
            ((_t(nw), tqkv, tsqkv, _t(bqkv)), (to, tso)))


def _pools(rng, pages, int8kv):
    k = (rng.standard_normal((pages, KV, PAGE, HD)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((pages, KV, PAGE, HD)) * 0.5).astype(np.float32)
    if not int8kv:
        return [k, v]
    kq, ks = JDB.kv_quant_rows(jnp.asarray(k))
    vq, vs = JDB.kv_quant_rows(jnp.asarray(v))
    return [np.asarray(a) for a in (kq, vq, ks, vs)]


def _paged(name, rng, x, rope, pools, index, kw):
    """Kernel ``name`` on both sides over copies of ``pools``: (jax outputs,
    port outputs, the pools before)."""
    (jhead, jtail), (thead, ttail) = _weights(rng)
    jfn, tfn = getattr(JDB, name), getattr(TDB, name)
    scales = pools[2:]

    def side(conv, head, tail, fn):
        p = [conv(np.array(a)) for a in pools]
        idx = [conv(a) if not isinstance(a, int) else a for a in index]
        return fn(conv(x), head[0], head[1], head[2], head[3], conv(rope[0]), conv(rope[1]),
                  p[0], p[1], tail[0], tail[1], *idx, *p[2:], **kw)

    want = side(jnp.asarray, jhead, jtail, jfn)
    got = side(_t, thead, ttail, tfn)
    assert len(got) == 3 + len(scales)
    return want, got


def _check_pools(got, want, before, written_rows):
    """fp pools within the module's tolerance; int8 ones' written bytes
    within 1 LSB and scales within 1e-5; every unwritten value and scale
    bit-unchanged. ``written_rows``: (page, row) pairs."""
    mask = np.zeros(before[0].shape[:3], bool)
    for pg, off in written_rows:
        mask[pg, :, off] = True
    if len(before) == 2:
        for g, w in zip(got, want):
            _close(g.numpy(), w)
        for g, b in zip(got, before):
            np.testing.assert_array_equal(g.numpy()[~mask], b[~mask])
        return
    for g, w, b in zip(got[:2], want[:2], before[:2]):
        g, w = g.numpy().astype(np.int32), np.asarray(w).astype(np.int32)
        assert np.abs(g[mask] - w[mask]).max() <= 1
        np.testing.assert_array_equal(g[~mask], b[~mask])
    for g, w, b in zip(got[2:], want[2:], before[2:]):
        np.testing.assert_allclose(g.numpy()[mask], np.asarray(w)[mask], rtol=1e-5, atol=0)
        np.testing.assert_array_equal(g.numpy()[~mask], b[~mask])


@pytest.mark.parametrize("int8kv", (False, True), ids=("fp_kv", "int8_kv"))
def test_paged_batch_step_int4_matches_pallas(int8kv):
    """Kernel 3: streams mid-page, at a page start and past two pages."""
    rng = np.random.default_rng(3)
    positions = [9, 16, 23, 5]
    b, npages = len(positions), S // PAGE
    bt = np.stack([1 + i * npages + np.arange(npages) for i in range(b)]).astype(np.int32)
    pools = _pools(rng, 1 + b * npages, int8kv)
    pos = np.asarray(positions, np.int32)
    cos_t, sin_t = JL.rope_table(S, HD)
    rope = [np.asarray(a) for a in JDB.rope_rows_at(cos_t, sin_t, jnp.asarray(pos))]
    x = rng.standard_normal((b, D)).astype(np.float32)
    want, got = _paged("attention_paged_batch_step", rng, x, rope, pools, (pos, bt),
                       dict(heads=H, kv_heads=KV, head_dim=HD))
    _close(got[0].numpy(), want[0])
    _check_pools(got[1:], want[1:], pools,
                 [(int(bt[i, p // PAGE]), p % PAGE) for i, p in enumerate(positions)])


@pytest.mark.parametrize("int8kv", (False, True), ids=("fp_kv", "int8_kv"))
def test_paged_chunk_step_int4_matches_pallas(int8kv):
    """Kernel 4: a 16-row chunk (two pages) after 16 rows of context."""
    rng = np.random.default_rng(4)
    m, position, npages = 16, 16, S // PAGE
    bt = np.arange(1, 1 + npages, dtype=np.int32)
    pools = _pools(rng, 1 + npages, int8kv)
    cos_t, sin_t = JL.rope_table(S, HD)
    rope = [np.asarray(a) for a in JDB.rope_rows(cos_t, sin_t, position, m)]
    x = rng.standard_normal((m, D)).astype(np.float32)
    want, got = _paged("attention_paged_chunk_step", rng, x, rope, pools, (position, bt),
                       dict(heads=H, kv_heads=KV, head_dim=HD))
    _close(got[0].numpy(), want[0])
    _check_pools(got[1:], want[1:], pools,
                 [(int(bt[r // PAGE]), r % PAGE) for r in range(position, position + m)])


@pytest.mark.parametrize("int8kv", (False, True), ids=("fp_kv", "int8_kv"))
def test_paged_spec_step_int4_matches_pallas(int8kv):
    """Kernel 5: verify chunks of m = 5, one straddling a page (6)."""
    rng = np.random.default_rng(5)
    m, positions, npages = 5, [9, 30, 6], S // PAGE
    b = len(positions)
    bt = np.stack([1 + i * npages + np.arange(npages) for i in range(b)]).astype(np.int32)
    pools = _pools(rng, 1 + b * npages, int8kv)
    pos = np.asarray(positions, np.int32)
    flat = (pos[:, None] + np.arange(m)[None, :]).reshape(-1).astype(np.int32)
    cos_t, sin_t = JL.rope_table(S, HD)
    rope = [np.asarray(a) for a in JDB.rope_rows_at(cos_t, sin_t, jnp.asarray(flat))]
    x = rng.standard_normal((b * m, D)).astype(np.float32)
    want, got = _paged("attention_paged_spec_step", rng, x, rope, pools, (pos, bt),
                       dict(heads=H, kv_heads=KV, head_dim=HD, m=m))
    _close(got[0].numpy(), want[0])
    _check_pools(got[1:], want[1:], pools,
                 [(int(bt[i, r // PAGE]), r % PAGE) for i, p in enumerate(positions)
                  for r in range(p, p + m)])


@pytest.mark.parametrize("name", ["attention_batch_step", "attention_step",
                                  "attention_chunk_step"])
def test_dense_steps_int4_match_pallas(name):
    """Kernels 8 (three planes at 0, 17 and 40), 9 (one row at 33) and 10
    (five rows from 38) over bf16-exact caches: outputs and caches."""
    rng = np.random.default_rng(len(name))
    (jhead, jtail), (thead, ttail) = _weights(rng)
    cos_t, sin_t = JL.rope_table(S, HD)
    if name == "attention_batch_step":
        positions = np.asarray([0, 17, 40], np.int32)
        rows, shape = len(positions), (len(positions), KV, S, HD)
        rope = JDB.rope_rows_at(cos_t, sin_t, jnp.asarray(positions))
        where = (positions,)
    else:
        rows, shape = (1, (KV, S, HD)) if name == "attention_step" else (5, (KV, S, HD))
        position = 33 if name == "attention_step" else 38
        rope = JDB.rope_rows(cos_t, sin_t, position, rows)
        where = (position,)
    rope = [np.asarray(a) for a in rope]
    x = rng.standard_normal((rows, D)).astype(np.float32)
    kc = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    vc = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    kw = dict(heads=H, kv_heads=KV, head_dim=HD)

    def side(conv, head, tail, fn):
        idx = [conv(a) if not isinstance(a, int) else a for a in where]
        return fn(conv(x), *head, conv(rope[0]), conv(rope[1]), conv(kc.copy()),
                  conv(vc.copy()), *tail, *idx, **kw)

    want = side(jnp.asarray, jhead, jtail, getattr(JDB, name))
    got = side(_t, thead, ttail, getattr(TDB, name))
    for g, w in zip(got, want):
        _close(g.numpy(), w)


# ---------------------------------------------------------------------------
# the unfused fallback and the limits
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows", (32, 33))
@pytest.mark.parametrize("sidecar", (True, False))
def test_matmul_int4_fallback_matches_jax(rows, sidecar):
    """Up to 32 rows, or with no sidecar, ``x @ dequantize_int4(w)``; above
    32 with one, the sidecar, as the JAX package dispatches."""
    rng = np.random.default_rng(rows)
    w = rng.standard_normal((D, 96)).astype(np.float32)
    x = rng.standard_normal((rows, D)).astype(np.float32)
    jw = J4.quantize_int4(jnp.asarray(w), keep_bf16=sidecar)
    tw = T4.quantize_int4(torch.from_numpy(w), keep_bf16=sidecar)
    want = JL.matmul(jnp.asarray(x), jw)
    got = TL.matmul(torch.from_numpy(x), tw)
    _close(got.numpy(), want)
    # the path taken: the sidecar's product, or the dequantized weight's
    w_used = (np.asarray(jw["bf16"].astype(jnp.float32)) if sidecar and rows > 32
              else np.asarray(J4.dequantize_int4(jw)))
    _close(got.numpy(), x @ w_used)


def test_wrappers_refuse_int4_groups_and_planes_the_kernels_do_not_take():
    """A group of 32 (K 96) is not a whole number of the int4 decode
    product's 128-deep stages; a per-column scale beside int4 bytes, or a
    group plane beside int8, is the wrong plane."""
    x = torch.zeros((2, 96), dtype=torch.bfloat16)
    nw = torch.ones(96)
    w32 = T4.quantize_int4(torch.randn(96, 64))
    wd = T4.quantize_int4(torch.randn(32, 96))  # F 32: a group of 32 too
    assert w32["gscale"].shape == (3, 64)
    with pytest.raises(ValueError, match="int4 group 32 of w_gateup: the kernels take groups "
                                         "that are multiples of 128"):
        TDB._mlp_step_kernel(x, nw, w32["int4"], w32["gscale"], None, wd["int4"],
                             wd["gscale"], eps=1e-6, residual=True, lib=object())
    w128 = T4.quantize_int4(torch.randn(128, 64))
    with pytest.raises(ValueError, match="int4 weights take group scales"):
        TDB._lm_head_argmax_kernel(torch.zeros((2, 128), dtype=torch.bfloat16), torch.ones(128),
                                   w128["int4"], w128["gscale"].reshape(-1), eps=1e-6,
                                   return_val=False, lib=object())
    with pytest.raises(ValueError, match="int8 weights take one scale a column"):
        TDB._lm_head_argmax_kernel(torch.zeros((2, 128), dtype=torch.bfloat16), torch.ones(128),
                                   torch.zeros((128, 64), dtype=torch.int8),
                                   torch.ones(2, 64), eps=1e-6, return_val=False,
                                   lib=object())
    assert TDB.int4_group_limits({"a": 128, "b": 256}) == []
    assert TDB.int4_group_limits({"a": 32, "b": 32, "c": 64}) == [
        "int4 group 32 of a: the kernels take groups that are multiples of 128",
        "int4 group 64 of c: the kernels take groups that are multiples of 128"]


def test_engine_factories_refuse_int4_group_32_on_the_card(monkeypatch):
    """ffn 96 gives w_down a group of 32: refused before the device is
    resolved by both engine factories and ``generate``; the CPU serves it."""
    from dora_tpu_torch.models import vlm as tvlm
    from dora_tpu_torch.models.hf import qwen2 as tq

    for knob in ("DORA_FUSED_DECODE", "DORA_INT4_DECODE", "DORA_INT8_PURE"):
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.setenv("DORA_WEIGHT_BITS", "4")
    cfg = tq.Qwen2Config(vocab=64, dim=128, layers=1, heads=2, kv_heads=1, ffn=96,
                         rope_theta=10000.0, norm_eps=1e-6, tie_embeddings=False, max_seq=64)
    params = tq.quantize_decode(tq.random_params(cfg, seed=0, device="cpu"), cfg)
    assert TDB.weight_groups(params)["blocks/0/w_down"] == 32
    msg = "int4 group 32 of blocks/0/w_down: the kernels take groups that are multiples of 128"
    with pytest.raises(ValueError, match="make_paged_engine: " + msg):
        tq.make_paged_engine(params, cfg)
    with pytest.raises(ValueError, match="make_batch_engine: " + msg):
        tq.make_batch_engine(params, cfg, device="cuda")
    ids = torch.tensor([[1, 2, 3]])
    assert tq.generate(params, cfg, ids, 2).shape == (1, 2)  # CPU: plain versions
    assert tq.make_paged_engine(params, cfg, device="cpu").max_seq == cfg.max_seq
    monkeypatch.setattr(tvlm, "on_card", lambda device: True)
    with pytest.raises(ValueError, match="qwen2.generate: " + msg):
        tq.generate(params, cfg, ids, 2)
