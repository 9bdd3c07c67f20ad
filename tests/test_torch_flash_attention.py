"""The port's flash attention (kernel 11) against dora_tpu's, on the CPU.

``flash_attention`` on CPU tensors runs its plain twin; it is held against
the JAX package's Pallas ``flash_attention``, run as tests/test_ops.py runs
it here (the Pallas interpreter), on the same seeded inputs: f32 within
2e-5 (absolute and relative; f32 sums in another order), bf16 inputs and
outputs within 2e-2 (a bf16 step of outputs of order one). The causal first
row equals v[0] to 1e-6. ``attention_sublayer(flash="full")`` matches the
JAX package's on a vision block of ``VLMConfig.tiny`` to 1e-5 of its
largest value, and ``use_flash`` reads ``DORA_FLASH_ATTENTION`` as the JAX
package does. The kernel itself is checked in
tests/test_torch_kernels_emulated.py and, on the card, by chip_smoke.py.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dora_tpu.ops import flash_attention as jax_flash
from dora_tpu_torch.ops import flash_attention as FA


def _inputs(seed, shape, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize(
    "b,h,t,d",
    [
        (1, 2, 128, 128),   # one reference block, aligned
        (2, 4, 256, 64),    # several blocks, D below the TPU's lanes
        (1, 2, 272, 80),    # the bench ViT's D, T off every block
        (1, 1, 100, 128),   # T below one block
    ],
)
def test_twin_matches_jax_flash(b, h, t, d, causal):
    q, k, v = _inputs(b * 1000 + t + d + causal, (b, h, t, d))
    want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal=causal))
    got = FA.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5)


def test_twin_bfloat16_io_matches_jax_flash():
    (q,) = _inputs(0, (1, 2, 128, 64))[:1]
    qj = jnp.asarray(q, jnp.bfloat16)
    want = np.asarray(jax_flash(qj, qj, qj, causal=True), np.float32)
    qt = torch.from_numpy(q).to(torch.bfloat16)
    got = FA.flash_attention(qt, qt, qt, causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2, rtol=2e-2)


def test_causal_first_row_attends_self_only():
    """Row 0 under causal masking sees exactly key 0: its output is v[0]."""
    q = torch.ones((1, 1, 128, 128))
    v = torch.arange(128 * 128, dtype=torch.float32).reshape(1, 1, 128, 128)
    out = FA.flash_attention(q, q, v, causal=True)
    np.testing.assert_allclose(out[0, 0, 0].numpy(), v[0, 0, 0].numpy(), rtol=1e-6)
    want = np.asarray(jax_flash(jnp.ones((1, 1, 128, 128)), jnp.ones((1, 1, 128, 128)),
                                jnp.asarray(v.numpy()), causal=True))
    np.testing.assert_allclose(out[0, 0, 0].numpy(), want[0, 0, 0], rtol=1e-6)


@pytest.mark.parametrize("flash", ["full", None])
def test_attention_sublayer_flash_matches_jax(flash, monkeypatch):
    """A vision block of VLMConfig.tiny (2 heads of 16, 16 patches) through
    attention_sublayer with flash="full" (and without, the dense einsum) on
    the JAX package's weights, with DORA_FLASH_ATTENTION=1."""
    from dora_tpu.models import layers as JL
    from dora_tpu.models import vlm as jvlm
    from dora_tpu_torch.models import layers as TL
    from dora_tpu_torch.models import vlm as tvlm

    monkeypatch.setenv("DORA_FLASH_ATTENTION", "1")
    cfg = jvlm.VLMConfig.tiny()
    jparams = jvlm.init_params(jax.random.PRNGKey(0), cfg)["vision"]["blocks"]["0"]
    tparams = tvlm.params_from_jax(jparams, device="cpu")
    x = np.random.default_rng(3).standard_normal((2, cfg.n_patches, cfg.vision_dim))
    x = x.astype(np.float32)
    want, _ = JL.attention_sublayer(jparams, jnp.asarray(x), cfg.vision_heads, flash=flash)
    got, cache = TL.attention_sublayer(tparams, torch.from_numpy(x), cfg.vision_heads,
                                       flash=flash)
    assert cache is None
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_flash_and_dense_sublayers_agree():
    """On the CPU the two routes of the no-cache path give the same block
    output to f32 rounding."""
    from dora_tpu_torch.models import layers as TL
    from dora_tpu_torch.models import vlm as tvlm

    cfg = tvlm.VLMConfig.tiny()
    blk = tvlm.init_params(cfg, seed=1, device="cpu")["vision"]["blocks"]["1"]
    x = torch.randn(1, cfg.n_patches, cfg.vision_dim, generator=torch.Generator().manual_seed(4))
    dense, _ = TL.attention_sublayer(blk, x, cfg.vision_heads)
    flashed, _ = TL.attention_sublayer(blk, x, cfg.vision_heads, flash="full")
    torch.testing.assert_close(flashed, dense, rtol=0, atol=1e-5 * float(dense.abs().max()))


def test_use_flash_default_and_override(monkeypatch):
    from dora_tpu_torch.models import layers as TL

    monkeypatch.delenv("DORA_FLASH_ATTENTION", raising=False)
    assert TL.use_flash("cuda") and not TL.use_flash("cpu")
    for value, on in (("1", True), ("0", False), ("", False), ("yes", True)):
        monkeypatch.setenv("DORA_FLASH_ATTENTION", value)
        assert TL.use_flash("cpu") is on and TL.use_flash("cuda") is on


def test_ring_and_ulysses_still_raise():
    from dora_tpu_torch.models import layers as TL
    from dora_tpu_torch.models import vlm as tvlm

    cfg = tvlm.VLMConfig.tiny()
    blk = tvlm.init_params(cfg, seed=0, device="cpu")["blocks"]["0"]
    x = torch.zeros(1, 4, cfg.dim)
    for kw in (dict(ring_axis="sp"), dict(sp_impl="ulysses"), dict(mesh=object())):
        with pytest.raises(NotImplementedError, match="dense or flash attention"):
            TL.attention_sublayer(blk, x, cfg.heads, n_kv_heads=cfg.kv_heads, **kw)


def test_kernel_shape_limits():
    assert FA.kernel_shape_limits(80) == [] and FA.kernel_shape_limits(16) == []
    assert FA.kernel_shape_limits(128) == []
    for d in (12, 136, 0):
        (msg,) = FA.kernel_shape_limits(d)
        assert f"head_dim {d}" in msg
