"""The port's decode sublayers (plain PyTorch versions) against the JAX
package's Pallas kernels, run in interpret mode on the CPU as
tests/test_ops.py runs them.

Same inputs (numpy, seeded) through both, in f32. Tolerance on float
outputs: 1e-4 relative plus 2e-5 of the output's largest magnitude absolute
(f32 sums of O(100) terms taken in another order; with these random weights
outputs reach O(100) and single elements cancel to O(0.01)). Argmax tokens
and untouched pool rows are exact.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dora_tpu.models import layers as JL
from dora_tpu.ops import decode_block as JDB
from dora_tpu.ops.int8_matmul import quantize_int8 as jquant
from dora_tpu_torch.models import layers as TL
from dora_tpu_torch.ops import decode_block as TDB


def _close(got, want):
    want = np.asarray(want)
    atol = 2e-5 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-4, atol=atol)


def _t(a):
    return torch.from_numpy(np.array(a))


def _q(rng, k, n):
    """One int8 weight quantized by the JAX package, for both sides."""
    q = jquant(jnp.asarray(rng.standard_normal((k, n)), jnp.float32))
    return q["int8"], q["scale"], _t(q["int8"]), _t(q["scale"])


@pytest.mark.parametrize("m,bias,residual", [(1, True, True), (5, False, True), (3, True, False)])
def test_mlp_step_matches_pallas(m, bias, residual):
    rng = np.random.default_rng(m)
    d, f = 64, 256
    x = rng.standard_normal((m, d)).astype(np.float32)
    nw = rng.standard_normal(d).astype(np.float32)
    jgu, jsgu, tgu, tsgu = _q(rng, d, 2 * f)
    jd, jsd, td, tsd = _q(rng, f, d)
    b = rng.standard_normal(2 * f).astype(np.float32) if bias else np.zeros(2 * f, np.float32)
    want = JDB.mlp_step(jnp.asarray(x), jnp.asarray(nw), jgu, jsgu, jnp.asarray(b), jd, jsd,
                        residual=residual)
    got = TDB.mlp_step(_t(x), _t(nw), tgu, tsgu, _t(b) if bias else None, td, tsd,
                       residual=residual)
    assert got.dtype == torch.float32
    _close(got.numpy(), want)


@pytest.mark.parametrize("m,vocab", [(1, 256), (5, 300), (16, 2100)])
def test_lm_head_argmax_matches_pallas(m, vocab):
    """Tokens exact, incl. a vocab that is not a tile multiple and a vocab
    spanning two of the TPU kernel's 2048-column tiles."""
    rng = np.random.default_rng(m * 1000 + vocab)
    d = 64
    x = rng.standard_normal((m, d)).astype(np.float32)
    nw = rng.standard_normal(d).astype(np.float32)
    jw, js, tw, ts = _q(rng, d, vocab)
    jtok, jval = JDB.lm_head_argmax(jnp.asarray(x), jnp.asarray(nw), jw, js, return_val=True)
    ttok, tval = TDB.lm_head_argmax(_t(x), _t(nw), tw, ts, return_val=True)
    assert ttok.dtype == torch.int32
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    _close(tval.numpy(), np.asarray(jval))
    np.testing.assert_array_equal(TDB.lm_head_argmax(_t(x), _t(nw), tw, ts).numpy(),
                                  np.asarray(jtok))


def test_lm_head_argmax_first_index_wins_ties():
    """Equal logits in two columns: the lower index wins, as jnp.argmax."""
    d, vocab = 8, 40
    w = np.zeros((d, vocab), np.int8)
    w[:, 7] = w[:, 31] = 5
    s = np.ones((1, vocab), np.float32)
    x = np.ones((2, d), np.float32)
    nw = np.ones(d, np.float32)
    tok = TDB.lm_head_argmax(_t(x), _t(nw), _t(w), _t(s))
    assert tok.tolist() == [7, 7]


def _attn_weights(rng, d, h, kv, hd):
    jqkv, jsqkv, tqkv, tsqkv = _q(rng, d, (h + 2 * kv) * hd)
    jo, jso, to, tso = _q(rng, h * hd, d)
    bqkv = rng.standard_normal((h + 2 * kv) * hd).astype(np.float32)
    nw = rng.standard_normal(d).astype(np.float32)
    return (jqkv, jsqkv, jo, jso), (tqkv, tsqkv, to, tso), bqkv, nw


def test_attention_paged_batch_step_matches_pallas():
    """B streams at positions that start a page, sit mid-page, end a page,
    and one frozen row (position 0, zeroed block-table row): outputs, the
    written rows, and every other live pool row bit-preserved."""
    rng = np.random.default_rng(3)
    d, h, kv, hd, page, npages = 64, 4, 2, 16, 8, 6
    positions = [9, 30, 16, 0, 23]
    frozen = [False, False, False, True, False]
    b = len(positions)
    (jqkv, jsqkv, jo, jso), (tqkv, tsqkv, to, tso), bqkv, nw = _attn_weights(rng, d, h, kv, hd)
    x = rng.standard_normal((b, d)).astype(np.float32)
    n_pool = 1 + b * npages
    kp = (rng.standard_normal((n_pool, kv, page, hd)) * 0.5).astype(np.float32)
    vp = (rng.standard_normal((n_pool, kv, page, hd)) * 0.5).astype(np.float32)
    bt = np.zeros((b, npages), np.int32)
    for i in range(b):
        if not frozen[i]:
            bt[i] = 1 + i * npages + np.arange(npages)
    cos_t, sin_t = JL.rope_table(npages * page, hd)
    pos = np.asarray(positions, np.int32)
    jc, js = JDB.rope_rows_at(cos_t, sin_t, jnp.asarray(pos))
    tc, ts = TDB.rope_rows_at(_t(cos_t), _t(sin_t), _t(pos))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))

    jx, jkp, jvp = JDB.attention_paged_batch_step(
        jnp.asarray(x), jnp.asarray(nw), jqkv, jsqkv, jnp.asarray(bqkv), jc, js,
        jnp.asarray(kp), jnp.asarray(vp), jo, jso, jnp.asarray(pos), jnp.asarray(bt),
        heads=h, kv_heads=kv, head_dim=hd,
    )
    tkp, tvp = _t(kp), _t(vp)
    tx, tkp2, tvp2 = TDB.attention_paged_batch_step(
        _t(x), _t(nw), tqkv, tsqkv, _t(bqkv), tc, ts, tkp, tvp, to, tso,
        _t(pos), _t(bt), heads=h, kv_heads=kv, head_dim=hd,
    )
    assert tkp2 is tkp and tvp2 is tvp  # updated in place
    _close(tx.numpy(), np.asarray(jx))
    # page 0 takes the frozen row's write: its content is don't-care
    _close(tkp[1:].numpy(), np.asarray(jkp)[1:])
    _close(tvp[1:].numpy(), np.asarray(jvp)[1:])
    written = np.zeros(kp.shape[:3], bool)
    for i, p in enumerate(positions):
        written[bt[i, p // page], :, p % page] = True
    written[0] = True
    np.testing.assert_array_equal(tkp.numpy()[~written], kp[~written])
    np.testing.assert_array_equal(tvp.numpy()[~written], vp[~written])


@pytest.mark.parametrize("position", (0, 16, 24))
def test_attention_paged_chunk_step_matches_pallas(position):
    """A 16-row chunk (two 8-row pages) at a page-aligned position through
    a scattered block table: outputs, the chunk's whole pages, and the
    prior pages untouched."""
    rng = np.random.default_rng(position + 1)
    d, h, kv, hd, page, m, npages = 64, 4, 2, 16, 8, 16, 6
    (jqkv, jsqkv, jo, jso), (tqkv, tsqkv, to, tso), bqkv, nw = _attn_weights(rng, d, h, kv, hd)
    x = rng.standard_normal((m, d)).astype(np.float32)
    n_pool = 2 * npages
    kp = (rng.standard_normal((n_pool, kv, page, hd)) * 0.5).astype(np.float32)
    vp = (rng.standard_normal((n_pool, kv, page, hd)) * 0.5).astype(np.float32)
    bt = (1 + rng.permutation(n_pool - 1)[:npages]).astype(np.int32)
    cos_t, sin_t = JL.rope_table(npages * page, hd)
    jc, js = JDB.rope_rows(cos_t, sin_t, position, m)
    tc, ts = TDB.rope_rows(_t(cos_t), _t(sin_t), position, m)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))

    jx, jkp, jvp = JDB.attention_paged_chunk_step(
        jnp.asarray(x), jnp.asarray(nw), jqkv, jsqkv, jnp.asarray(bqkv), jc, js,
        jnp.asarray(kp), jnp.asarray(vp), jo, jso, position, jnp.asarray(bt),
        heads=h, kv_heads=kv, head_dim=hd,
    )
    tkp, tvp = _t(kp), _t(vp)
    tx, _, _ = TDB.attention_paged_chunk_step(
        _t(x), _t(nw), tqkv, tsqkv, _t(bqkv), tc, ts, tkp, tvp, to, tso,
        position, _t(bt), heads=h, kv_heads=kv, head_dim=hd,
    )
    _close(tx.numpy(), np.asarray(jx))
    _close(tkp.numpy(), np.asarray(jkp))
    _close(tvp.numpy(), np.asarray(jvp))
    chunk_pages = set(bt[position // page : position // page + m // page].tolist())
    others = [p for p in range(n_pool) if p not in chunk_pages]
    np.testing.assert_array_equal(tkp.numpy()[others], kp[others])


def test_freeze_inactive_matches_jax():
    pos = np.asarray([5, 9, 0, 17], np.int32)
    bts = np.arange(1, 13, dtype=np.int32).reshape(4, 3)
    active = np.asarray([True, False, True, False])
    jp, jb = JDB.freeze_inactive(jnp.asarray(pos), jnp.asarray(bts), jnp.asarray(active))
    tp, tb = TDB.freeze_inactive(_t(pos), _t(bts), _t(active))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    assert tp.dtype == torch.int32 and tb.dtype == torch.int32


@pytest.mark.parametrize("position,length", [(0, 1), (7, 4), (60, 8)])
def test_rope_rows_match_jax(position, length):
    """Including a slice that runs past the table, whose start clamps as
    lax.dynamic_slice's does."""
    cos_t, sin_t = JL.rope_table(64, 16, base=1e6)
    tcos, tsin = TL.rope_table(64, 16, base=1e6, device="cpu")
    np.testing.assert_allclose(tcos.numpy(), np.asarray(cos_t), atol=1e-6)
    np.testing.assert_allclose(tsin.numpy(), np.asarray(sin_t), atol=1e-6)
    jc, js = JDB.rope_rows(cos_t, sin_t, position, length)
    tc, ts = TDB.rope_rows(_t(cos_t), _t(sin_t), position, length)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 32)).astype(np.float32)
    w = rng.standard_normal(32).astype(np.float32)
    np.testing.assert_allclose(
        TL.rms_norm(_t(x), _t(w)).numpy(),
        np.asarray(JL.rms_norm(jnp.asarray(x), jnp.asarray(w))), rtol=1e-6, atol=1e-6,
    )


def test_attention_paged_spec_step_matches_pallas_and_dense_oracle():
    """tests/test_ops.py's geometry: page 8, m 5, streams at positions 9
    and 30, one whose 5 rows straddle a page (6), one frozen (0, zeroed
    table row). The plain twin against the Pallas kernel (interpret mode)
    and against the per-stream dense oracle that test builds
    (attention_chunk_step on each stream's dense cache): output rows and
    the written pool rows within the module's tolerance, every other row
    of a live page bit-unchanged."""
    rng = np.random.default_rng(3)
    d, h, kv, hd, s, m, page, b = 64, 4, 2, 16, 64, 5, 8, 4
    npages = s // page
    positions = [9, 30, 6, 0]
    frozen = [False, False, False, True]
    (jqkv, jsqkv, jo, jso), (tqkv, tsqkv, to, tso), bqkv, nw = _attn_weights(rng, d, h, kv, hd)
    x = rng.standard_normal((b * m, d)).astype(np.float32)
    dense_k = [(rng.standard_normal((kv, s, hd)) * 0.1).astype(np.float32) for _ in range(b)]
    dense_v = [(rng.standard_normal((kv, s, hd)) * 0.1).astype(np.float32) for _ in range(b)]
    n_pool = 1 + b * npages
    kp = np.zeros((n_pool, kv, page, hd), np.float32)
    vp = np.zeros((n_pool, kv, page, hd), np.float32)
    bt = np.zeros((b, npages), np.int32)
    for i in range(b):
        if frozen[i]:
            continue
        for j in range(npages):
            bt[i, j] = 1 + i * npages + j
            kp[bt[i, j]] = dense_k[i][:, j * page : (j + 1) * page]
            vp[bt[i, j]] = dense_v[i][:, j * page : (j + 1) * page]
    cos_t, sin_t = JL.rope_table(s, hd)
    pos = np.asarray(positions, np.int32)
    flat = (pos[:, None] + np.arange(m)[None, :]).reshape(b * m).astype(np.int32)
    jc, js = JDB.rope_rows_at(cos_t, sin_t, jnp.asarray(flat))
    tc, ts = TDB.rope_rows_at(_t(cos_t), _t(sin_t), _t(flat))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))

    jx, jkp, jvp = JDB.attention_paged_spec_step(
        jnp.asarray(x), jnp.asarray(nw), jqkv, jsqkv, jnp.asarray(bqkv), jc, js,
        jnp.asarray(kp), jnp.asarray(vp), jo, jso, jnp.asarray(pos), jnp.asarray(bt),
        heads=h, kv_heads=kv, head_dim=hd, m=m,
    )
    tkp, tvp = _t(kp), _t(vp)
    tx, tkp2, _ = TDB.attention_paged_spec_step(
        _t(x), _t(nw), tqkv, tsqkv, _t(bqkv), tc, ts, tkp, tvp, to, tso,
        _t(pos), _t(bt), heads=h, kv_heads=kv, head_dim=hd, m=m,
    )
    assert tkp2 is tkp  # updated in place
    _close(tx.numpy(), np.asarray(jx))
    # page 0 takes the frozen stream's rows: its content is don't-care
    _close(tkp[1:].numpy(), np.asarray(jkp)[1:])
    _close(tvp[1:].numpy(), np.asarray(jvp)[1:])
    written = np.zeros(kp.shape[:3], bool)
    for i, p in enumerate(positions):
        for r in range(p, p + m):
            written[bt[i, r // page], :, r % page] = True
    written[0] = True
    assert written[bt[2, 0], :, 6:].all() and written[bt[2, 1], :, :3].all()  # the straddle
    np.testing.assert_array_equal(tkp.numpy()[~written], kp[~written])
    np.testing.assert_array_equal(tvp.numpy()[~written], vp[~written])

    for i, p in enumerate(positions):
        cr, sr = JDB.rope_rows(cos_t, sin_t, p, m)
        ref_x, ref_k, ref_v = JDB.attention_chunk_step(
            jnp.asarray(x[i * m : (i + 1) * m]), jnp.asarray(nw), jqkv, jsqkv,
            jnp.asarray(bqkv), cr, sr, jnp.asarray(dense_k[i]), jnp.asarray(dense_v[i]),
            jo, jso, p, heads=h, kv_heads=kv, head_dim=hd,
        )
        _close(tx[i * m : (i + 1) * m].numpy(), np.asarray(ref_x))
        if frozen[i]:
            continue
        for r in range(p, p + m):
            pg, off = bt[i, r // page], r % page
            _close(tkp[pg, :, off].numpy(), np.asarray(ref_k)[:, r])
            _close(tvp[pg, :, off].numpy(), np.asarray(ref_v)[:, r])
