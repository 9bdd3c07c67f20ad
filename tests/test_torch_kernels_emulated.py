"""The CUDA kernels' sources, built for the host (csrc/emu/: one OS thread
per CUDA thread, blocks in turn) and held against their plain PyTorch
versions on the CPU, in bf16 at small sizes with the kernels' own head_dim
128 and page 16.

This checks the kernels' indexing, masking and reductions without a card;
it says nothing of how they compile or run on one (chip_smoke.py does).
Tolerance: the largest error at most 1e-2 of the output's largest
magnitude, the bf16 rounding of the kernels' bf16 intermediates and
outputs (the kernel rounds softmax weights against the running max, the
plain version against the final max); argmax tokens exact; untouched pool
rows exact.
"""

from __future__ import annotations

import shutil

import numpy as np
import pytest
import torch

from dora_tpu_torch.ops import _build
from dora_tpu_torch.ops import decode_block as DB
from dora_tpu_torch.ops.int8_matmul import quantize_int8

BF = torch.bfloat16


@pytest.fixture(scope="module")
def libs():
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler for the emulated kernel build")
    return {
        n: _build.library(n, DB._SIGNATURES[n], compiler="host")
        for n in _build.SOURCES
    }


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _rel(got, want) -> float:
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)).item()


@pytest.mark.parametrize("m,bias,residual", [(3, True, True), (20, False, False)])
def test_mlp_kernel_matches_plain(libs, m, bias, residual):
    rng = np.random.default_rng(m)
    d, f = 96, 80
    x = _t(rng.standard_normal((m, d)), BF)
    nw = _t(rng.standard_normal(d))
    wgu = quantize_int8(_t(rng.standard_normal((d, 2 * f))))
    wd = quantize_int8(_t(rng.standard_normal((f, d))))
    b = _t(rng.standard_normal(2 * f)) if bias else None
    args = (x, nw, wgu["int8"], wgu["scale"], b, wd["int8"], wd["scale"])
    want = DB.mlp_step_plain(*args, residual=residual)
    got = DB._mlp_step_kernel(*args, eps=1e-6, residual=residual, lib=libs["mlp"])
    assert got.dtype == want.dtype
    assert _rel(got, want) <= 1e-2


@pytest.mark.parametrize("m,vocab", [(3, 300), (20, 1000)])
def test_lm_head_kernel_matches_plain(libs, m, vocab):
    rng = np.random.default_rng(vocab)
    d = 96
    x = _t(rng.standard_normal((m, d)), BF)
    nw = _t(rng.standard_normal(d))
    wh = quantize_int8(_t(rng.standard_normal((d, vocab))))
    ti, tv = DB.lm_head_argmax_plain(x, nw, wh["int8"], wh["scale"], return_val=True)
    gi, gv = DB._lm_head_argmax_kernel(x, nw, wh["int8"], wh["scale"], eps=1e-6,
                                       return_val=True, lib=libs["lm_head"])
    assert torch.equal(gi, ti)
    assert _rel(gv, tv) <= 1e-2


def _attn_setup(rng, d=64, h=4, kv=2, hd=128):
    wqkv = quantize_int8(_t(rng.standard_normal((d, (h + 2 * kv) * hd))))
    wo = quantize_int8(_t(rng.standard_normal((h * hd, d))))
    bqkv = _t(rng.standard_normal((h + 2 * kv) * hd))
    nw = _t(rng.standard_normal(d))
    inv = 1.0 / 10000.0 ** (torch.arange(0, hd, 2, dtype=torch.float32) / hd)
    freqs = torch.outer(torch.arange(128, dtype=torch.float32), inv)
    return wqkv, wo, bqkv, nw, torch.cos(freqs), torch.sin(freqs)


def test_paged_batch_kernel_matches_plain(libs):
    """Rows mid-page, at a page start, frozen (position 0, zeroed table
    row) and past three pages."""
    rng = np.random.default_rng(0)
    h, kv, hd, page, maxp, d = 4, 2, 128, 16, 6, 64
    wqkv, wo, bqkv, nw, cos_t, sin_t = _attn_setup(rng, d, h, kv, hd)
    positions = torch.tensor([17, 32, 0, 5, 50], dtype=torch.int32)
    b = positions.shape[0]
    bt = torch.zeros((b, maxp), dtype=torch.int32)
    for i in (0, 1, 3, 4):
        bt[i] = 1 + i * maxp + torch.arange(maxp, dtype=torch.int32)
    n_pool = 1 + b * maxp
    kp = _t(rng.standard_normal((n_pool, kv, page, hd)) * 0.5, BF)
    vp = _t(rng.standard_normal((n_pool, kv, page, hd)) * 0.5, BF)
    x = _t(rng.standard_normal((b, d)), BF)
    cr, sr = DB.rope_rows_at(cos_t, sin_t, positions)
    kw = dict(heads=h, kv_heads=kv, head_dim=hd)
    k1, v1, k2, v2 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    want, _, _ = DB.attention_paged_batch_step_plain(
        x, nw, wqkv["int8"], wqkv["scale"], bqkv, cr, sr, k1, v1,
        wo["int8"], wo["scale"], positions, bt, **kw)
    got, _, _ = DB._attention_paged_batch_step_kernel(
        x, nw, wqkv["int8"], wqkv["scale"], bqkv, cr, sr, k2, v2,
        wo["int8"], wo["scale"], positions, bt, eps=1e-6, residual=True,
        lib=libs["paged_attention"], **kw)
    assert _rel(got, want) <= 1e-2
    assert _rel(k2[1:], k1[1:]) <= 1e-2 and _rel(v2[1:], v1[1:]) <= 1e-2
    written = torch.zeros(kp.shape[:3], dtype=torch.bool)
    for i, p in enumerate(positions.tolist()):
        written[bt[i, p // page], :, p % page] = True
    written[0] = True
    assert torch.equal(k2[~written], kp[~written])
    assert torch.equal(v2[~written], vp[~written])


@pytest.mark.parametrize("position", (0, 48))
def test_paged_chunk_kernel_matches_plain(libs, position):
    rng = np.random.default_rng(position + 1)
    h, kv, hd, page, maxp, d, m = 4, 2, 128, 16, 6, 64, 32
    wqkv, wo, bqkv, nw, cos_t, sin_t = _attn_setup(rng, d, h, kv, hd)
    n_pool = 10
    bt = torch.from_numpy((1 + rng.permutation(n_pool - 1)[:maxp]).astype(np.int32))
    kp = _t(rng.standard_normal((n_pool, kv, page, hd)) * 0.5, BF)
    vp = _t(rng.standard_normal((n_pool, kv, page, hd)) * 0.5, BF)
    x = _t(rng.standard_normal((m, d)), BF)
    cr, sr = DB.rope_rows(cos_t, sin_t, position, m)
    kw = dict(heads=h, kv_heads=kv, head_dim=hd)
    k1, v1, k2, v2 = kp.clone(), vp.clone(), kp.clone(), vp.clone()
    want, _, _ = DB.attention_paged_chunk_step_plain(
        x, nw, wqkv["int8"], wqkv["scale"], bqkv, cr, sr, k1, v1,
        wo["int8"], wo["scale"], position, bt, **kw)
    got, _, _ = DB._attention_paged_chunk_step_kernel(
        x, nw, wqkv["int8"], wqkv["scale"], bqkv, cr, sr, k2, v2,
        wo["int8"], wo["scale"], position, bt, eps=1e-6, residual=True,
        lib=libs["paged_attention"], **kw)
    assert _rel(got, want) <= 1e-2
    assert _rel(k2, k1) <= 1e-2 and _rel(v2, v1) <= 1e-2
    chunk = set(bt[position // page : position // page + m // page].tolist())
    others = [p for p in range(n_pool) if p not in chunk]
    assert torch.equal(k2[others], kp[others])


def test_kernel_wrappers_refuse_shapes_the_kernels_do_not_take():
    x = torch.zeros((2, 64), dtype=BF)
    with pytest.raises(ValueError, match="head_dim 128 and page 16"):
        DB._attention_paged_batch_step_kernel(
            x, None, None, None, None, None, None,
            torch.zeros((3, 2, 8, 16), dtype=BF), None, None, None, None,
            torch.zeros((2, 4), dtype=torch.int32), heads=4, kv_heads=2,
            head_dim=16, eps=1e-6, residual=True, lib=object())
    with pytest.raises(ValueError, match="dtype"):
        DB._mlp_step_kernel(
            x.float(), torch.ones(64), torch.zeros((64, 32), dtype=torch.int8),
            torch.ones(1, 32), None, torch.zeros((16, 64), dtype=torch.int8),
            torch.ones(1, 64), eps=1e-6, residual=True, lib=object())
