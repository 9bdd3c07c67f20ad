"""The port's layer primitives that the HF vision-language families add,
against dora_tpu/models/layers.py on the CPU, on numpy-seeded inputs:
``layer_norm`` (f32 and bf16 inputs), ``apply_rope_tables`` (shared [T, D/2]
and per-row [B, T, D/2] tables), the ``rope_tables=`` argument of
``block_forward`` (without and with a cache) and ``resize_image`` against
``jax.image.resize``. f32 results agree within F32_TOL of the largest
magnitude (sums in another order); a bf16 result within one bf16 rounding
(BF16_TOL)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dora_tpu.models import layers as JL
from dora_tpu_torch.models import layers as TL

F32_TOL = 1e-5
BF16_TOL = 2 ** -7


def _close(got, want, tol=F32_TOL):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("eps", [1e-6, 1e-5])
def test_layer_norm_matches_jax(dtype, eps):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(3, 5, 48)) * 3 + 1).astype(np.float32)
    w = rng.normal(size=(48,)).astype(np.float32)
    b = rng.normal(size=(48,)).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = JL.layer_norm(jx, jnp.asarray(w), jnp.asarray(b), eps)
    got = TL.layer_norm(tx, torch.from_numpy(w), torch.from_numpy(b), eps)
    assert got.dtype == tx.dtype
    _close(got, want, F32_TOL if dtype == "float32" else BF16_TOL)


@pytest.mark.parametrize("per_row", [False, True], ids=["shared", "per-row"])
def test_apply_rope_tables_matches_jax(per_row):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 3, 7, 16)).astype(np.float32)
    angles = rng.uniform(0, 50, size=((2, 7, 8) if per_row else (7, 8))).astype(np.float32)
    cos, sin = np.cos(angles), np.sin(angles)
    want = JL.apply_rope_tables(jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin))
    got = TL.apply_rope_tables(torch.from_numpy(x), torch.from_numpy(cos), torch.from_numpy(sin))
    _close(got, want)
    # position-indexed rope is the per-token form of its table rows
    pos = rng.integers(0, 30, size=(2, 7))
    ct, st = TL.rope_table(30, 16, device="cpu")
    np.testing.assert_array_equal(
        TL.apply_rope(torch.from_numpy(x), ct, st, torch.from_numpy(pos)).numpy(),
        TL.apply_rope_tables(torch.from_numpy(x), ct[pos], st[pos]).numpy())


def _block(rng, dim=32, heads=4, kv=2, ffn=48):
    hd = dim // heads

    def w(*shape):
        return (rng.normal(size=shape) * 0.2).astype(np.float32)

    return {"attn_norm": 1 + w(dim), "wq": w(dim, heads * hd), "wk": w(dim, kv * hd),
            "wv": w(dim, kv * hd), "bq": w(heads * hd), "bk": w(kv * hd), "bv": w(kv * hd),
            "wo": w(heads * hd, dim), "ffn_norm": 1 + w(dim), "w_gate": w(dim, ffn),
            "w_up": w(dim, ffn), "w_down": w(ffn, dim)}


@pytest.mark.parametrize("cached", [False, True], ids=["no-cache", "cache"])
def test_block_forward_rope_tables_matches_jax(cached):
    """Per-row [B, T, D/2] tables (M-RoPE's shape) through the block, alone
    and writing a cache at row 3 under a mask over the whole cache."""
    rng = np.random.default_rng(2)
    blk = _block(rng)
    b, t, s = 2, 5, 12
    x = rng.normal(size=(b, t, 32)).astype(np.float32)
    angles = rng.uniform(0, 20, size=(b, t, 4)).astype(np.float32)
    cos, sin = np.cos(angles), np.sin(angles)
    jblk = {k: jnp.asarray(v) for k, v in blk.items()}
    tblk = {k: torch.from_numpy(v) for k, v in blk.items()}
    kw_j = dict(n_kv_heads=2, rope_tables=(jnp.asarray(cos), jnp.asarray(sin)))
    kw_t = dict(n_kv_heads=2, rope_tables=(torch.from_numpy(cos), torch.from_numpy(sin)))
    if cached:
        cache = rng.normal(size=(b, 2, s, 8)).astype(np.float32)
        mask = np.arange(s)[None, None, None, :] <= (3 + np.arange(t))[None, None, :, None]
        kw_j.update(mask=jnp.asarray(mask), cache_index=3,
                    cache={"k": jnp.asarray(cache), "v": jnp.asarray(cache * 0.5)})
        kw_t.update(mask=torch.from_numpy(mask), cache_index=3,
                    cache={"k": torch.from_numpy(cache.copy()),
                           "v": torch.from_numpy(cache * 0.5)})
    else:
        mask = np.tril(np.ones((t, t), bool))[None, None]
        kw_j.update(mask=jnp.asarray(mask))
        kw_t.update(mask=torch.from_numpy(mask))
    want, jcache = JL.block_forward(jblk, jnp.asarray(x), 4, **kw_j)
    got, tcache = TL.block_forward(tblk, torch.from_numpy(x), 4, **kw_t)
    _close(got, want)
    if cached:
        _close(tcache["k"], jcache["k"])
        _close(tcache["v"], jcache["v"])
    else:
        assert tcache is None and jcache is None


@pytest.mark.parametrize("method", ["bilinear", "bicubic"])
@pytest.mark.parametrize("size", [(16, 40), (45, 90), (120, 200), (30, 60)],
                         ids=["shrink", "shrink-rows", "enlarge", "same"])
def test_resize_image_matches_jax(method, size):
    """Antialiased when shrinking, half-pixel centres: within a few 1e-7 of
    values in [0, 1]."""
    img = np.random.default_rng(3).uniform(size=(30, 60, 3)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(img), (*size, 3), method=method)
    got = TL.resize_image(torch.from_numpy(img), *size, method)
    assert got.shape == (*size, 3)
    _close(got, want)
