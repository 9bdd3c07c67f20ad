"""The port's self-contained VLM against dora_tpu's, on the CPU.

On ``VLMConfig.tiny`` with the JAX package's seeded weights carried over by
``params_from_jax``, and numpy-seeded images and prompts, in f32 (both
packages' CPU compute dtype):

* ``encode_image`` matches with flash attention on and off
  (``DORA_FLASH_ATTENTION``; the JAX side runs its Pallas kernel in the
  interpreter), within 1e-5 of the largest value (f32 sums in another
  order); so do the ``prefill`` logits and a ``decode_step``'s;
* decoding a token against the cache gives the logits of the longer
  prefill (2e-4, the JAX package's own teacher-forcing bound);
* ``generate`` tokens are exact, unquantized (the unfused steps, batch 2
  and 1) and quantized (batch 1: the fused tier, the kernels' plain twins
  here, the Pallas interpreter there); the port's ``quantize_decode`` makes
  byte for byte the tree that ``params_from_jax`` makes of the JAX one's;
* ``generate_speculative`` tokens and pass counts equal the JAX package's
  (unquantized and quantized), and equal plain ``generate``'s tokens;
* ``gate_speculation`` and the headroom guard behave as the JAX package's.
"""

from __future__ import annotations

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dora_tpu.models import vlm as jvlm
from dora_tpu_torch.models import vlm as tvlm

CFG = jvlm.VLMConfig.tiny()
TCFG = tvlm.VLMConfig.tiny()


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, tol=1e-5):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-30))


def _tree_equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for key in a:
            _tree_equal(a[key], b[key], f"{path}/{key}")
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert torch.equal(a, b), path


@pytest.fixture(scope="module")
def jparams():
    return jvlm.init_params(jax.random.PRNGKey(0), CFG)


@pytest.fixture(scope="module")
def jquant(jparams):
    return jvlm.quantize_decode(jparams)


@pytest.fixture(scope="module")
def tparams(jparams):
    return tvlm.params_from_jax(jparams, device="cpu")


@pytest.fixture(scope="module")
def tquant(jquant):
    return tvlm.params_from_jax(jquant, device="cpu")


def _data(seed, b=1, t=5):
    rng = np.random.default_rng(seed)
    images = rng.uniform(size=(b, CFG.image_size, CFG.image_size, 3)).astype(np.float32)
    prompt = rng.integers(0, CFG.vocab, size=(b, t)).astype(np.int32)
    return (jnp.asarray(images), jnp.asarray(prompt)), (torch.from_numpy(images),
                                                       torch.from_numpy(prompt))


def test_config_shapes_match_jax():
    for name in ("tiny", "bench_2b"):
        j, t = getattr(jvlm.VLMConfig, name)(), getattr(tvlm.VLMConfig, name)()
        assert j.__dict__ == t.__dict__
        assert (j.n_patches, j.head_dim) == (t.n_patches, t.head_dim)
    b2 = tvlm.VLMConfig.bench_2b()
    assert (b2.n_patches, b2.vision_head_dim, b2.head_dim) == (256, 80, 128)


def test_init_params_shapes_and_distributions_match_jax(jparams):
    """The port's own seeded weights have the JAX tree's leaves and shapes,
    dense weights within +-1/sqrt(d_in), norms one, embeddings ~0.02."""
    ours = tvlm.init_params(TCFG, seed=0, device="cpu")
    theirs = tvlm.params_from_jax(jparams, device="cpu")

    def walk(a, b, path=""):
        if isinstance(a, dict):
            assert set(a) == set(b), path
            for key in a:
                walk(a[key], b[key], f"{path}/{key}")
        else:
            assert a.shape == b.shape and a.dtype == b.dtype == torch.float32, path

    walk(ours, theirs)
    assert tvlm.param_count(ours) == int(jvlm.param_count(jparams))
    wq = ours["blocks"]["0"]["wq"]
    assert float(wq.abs().max()) <= 1 / np.sqrt(TCFG.dim) and float(wq.std()) > 0
    assert torch.equal(ours["out_norm"], torch.ones(TCFG.dim))
    assert 0.015 < float(ours["embed"].std()) < 0.025


def test_quantize_decode_matches_params_from_jax(tparams, tquant):
    _tree_equal(tvlm.quantize_decode(tparams), tquant)


@pytest.mark.parametrize("flash", ["1", "0"])
def test_encode_image_matches_jax(jparams, tparams, flash, monkeypatch):
    monkeypatch.setenv("DORA_FLASH_ATTENTION", flash)
    (jimg, _), (timg, _) = _data(1, b=2)
    want = jvlm.encode_image(jparams, CFG, jimg)
    got = tvlm.encode_image(tparams, TCFG, timg)
    assert got.shape == (2, CFG.n_patches, CFG.dim)
    _close(got, want)


def test_patchify_matches_jax():
    x = np.arange(2 * 16 * 16 * 3, dtype=np.float32).reshape(2, 16, 16, 3)
    np.testing.assert_array_equal(_np(tvlm.patchify(torch.from_numpy(x), 4)),
                                  np.asarray(jvlm.patchify(jnp.asarray(x), 4)))


def test_prefill_and_decode_step_match_jax(jparams, tparams):
    (jimg, jids), (timg, tids) = _data(2, b=2, t=6)
    jl, jc, jpos = jvlm.prefill(jparams, CFG, jimg, jids)
    tl, tc, tpos = tvlm.prefill(tparams, TCFG, timg, tids)
    assert tpos == jpos == CFG.n_patches + 6
    _close(tl, jl)
    for i in jc:
        _close(tc[i]["k"], jc[i]["k"])
    tok = np.array([3, 77], np.int32)
    jl2, _ = jvlm.decode_step(jparams, CFG, jnp.asarray(tok), jc, jnp.asarray(jpos))
    tl2, _ = tvlm.decode_step(tparams, TCFG, torch.from_numpy(tok), tc, tpos)
    _close(tl2, jl2)


def test_decode_matches_prefill(tparams):
    """Teacher forcing: decoding token t against the cache gives the logits
    of a prefill one token longer."""
    _, (timg, tids) = _data(3, b=1, t=4)
    logits_a, caches, pos = tvlm.prefill(tparams, TCFG, timg, tids)
    nxt = torch.argmax(logits_a, dim=-1).to(torch.int32)
    logits_b, _ = tvlm.decode_step(tparams, TCFG, nxt, caches, pos)
    logits_c, _, _ = tvlm.prefill(tparams, TCFG, timg, torch.cat([tids, nxt[:, None]], dim=1))
    np.testing.assert_allclose(_np(logits_b), _np(logits_c), atol=2e-4)


@pytest.mark.parametrize("quantized,b,max_new", [
    pytest.param(q, b, n, id=f"{q}-{b}" + ("" if n else "-zero"))
    for n in (12, 0) for q, b in ((False, 2), (False, 1), (True, 1))])
def test_generate_tokens_match_jax(jparams, tparams, jquant, tquant, quantized, b, max_new):
    """Tokens equal the JAX package's; at 0 new tokens both are an empty
    [B, 0] int32."""
    jp, tp = (jquant, tquant) if quantized else (jparams, tparams)
    assert tvlm.fused_decode_ready(tp, b) == (quantized and b == 1)
    (jimg, jids), (timg, tids) = _data(10 + b, b=b)
    want = np.asarray(jvlm.generate(jp, CFG, jimg, jids, max_new))
    got = tvlm.generate(tp, TCFG, timg, tids, max_new)
    assert got.dtype == torch.int32 and got.shape == want.shape == (b, max_new)
    np.testing.assert_array_equal(_np(got), want)


def test_decode_batch_fused_matches_jax(jquant, tquant):
    """B independent rows at their own positions through the batched fused
    pass (attention_batch_step's twin against the Pallas interpreter)."""
    caches_j = jvlm.init_cache(CFG, 3)
    caches_t = tvlm.init_cache(TCFG, 3, device="cpu")
    tokens = np.array([5, 9, 200], np.int32)
    positions = np.array([0, 7, 20], np.int32)
    jg, jc = jvlm.decode_batch_fused(jquant, CFG, jnp.asarray(tokens), caches_j,
                                     jnp.asarray(positions))
    tg, tc = tvlm.decode_batch_fused(tquant, TCFG, torch.from_numpy(tokens), caches_t,
                                     torch.from_numpy(positions))
    np.testing.assert_array_equal(_np(tg), np.asarray(jg))
    _close(tc["1"]["k"], jc["1"]["k"])


@pytest.mark.parametrize("seed,quantized,max_new", [
    pytest.param(seed, q, n, id=f"{seed}-{q}" + ("" if n else "-zero"))
    for n in (16, 0) for seed in range(3 if n else 1) for q in (False, True)])
def test_generate_speculative_matches_jax(jparams, tparams, jquant, tquant, quantized, seed,
                                          max_new):
    """Tokens and model passes equal the JAX package's, and the tokens equal
    plain greedy generation's; at 0 new tokens an empty [1, 0] after the one
    pass the JAX loop counts too."""
    jp, tp = (jquant, tquant) if quantized else (jparams, tparams)
    (jimg, jids), (timg, tids) = _data(100 + seed)
    want, want_passes = jvlm.generate_speculative(jp, CFG, jimg, jids, max_new)
    got, passes = tvlm.generate_speculative(tp, TCFG, timg, tids, max_new)
    assert got.dtype == torch.int32 and got.shape == np.asarray(want).shape == (1, max_new)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    assert passes == int(want_passes)
    np.testing.assert_array_equal(_np(got), _np(tvlm.generate(tp, TCFG, timg, tids, max_new)))


def test_speculative_context_guard(tparams):
    _, (timg, tids) = _data(0, t=10)
    with pytest.raises(ValueError, match="speculation headroom"):
        tvlm.generate_speculative(tparams, TCFG, timg, tids, 40)
    with pytest.raises(ValueError, match="batch-1"):
        tvlm.generate_speculative(tparams, TCFG, *(_data(0, b=2)[1]), 4)
    with pytest.raises(ValueError, match="exceeds max_seq"):
        tvlm.generate(tparams, TCFG, timg, tids, 40)


def test_gate_speculation_matches_jax(monkeypatch, caplog):
    from dora_tpu.models import spec_decode as jsd
    from dora_tpu_torch.models import spec_decode as tsd

    assert tsd.SPEC_HEADROOM == jsd.SPEC_HEADROOM == 5
    cases = [(16, 16, 64, True), (40, 20, 64, True), (16, 16, 64, False), (59, 0, 64, True)]
    for env in (None, "1"):
        if env is None:
            monkeypatch.delenv("DORA_SPEC_DECODE", raising=False)
        else:
            monkeypatch.setenv("DORA_SPEC_DECODE", env)
        for ctx, new, seq, batch_ok in cases:
            assert tsd.fits(ctx, new, seq) == jsd.fits(ctx, new, seq)
            assert tsd.gate_speculation(ctx, new, seq, batch_ok) == jsd.gate_speculation(
                ctx, new, seq, batch_ok)
    with caplog.at_level(logging.WARNING, logger=tsd.__name__):
        assert not tsd.gate_speculation(40, 20, 64)
    assert "DORA_SPEC_DECODE disabled" in caplog.text
    assert tsd.gate_speculation(16, 16, 64)
