"""The port's training against dora_tpu's, on the CPU.

Kernel 11 with a gradient: ``flash_attention`` on inputs that require grad
goes through ``FlashAttention`` (its forward the kernel on the card, the
plain version here), whose backward is held against torch.autograd through
``flash_attention_plain`` and against ``jax.grad`` of the JAX package's
dense attention (the JAX flash kernel has no backward), f32 within 1e-5 of
the largest gradient.

On ``VLMConfig.tiny`` with the JAX package's seeded weights carried over by
``params_from_jax`` and numpy-seeded batches, in f32:

* ``vlm.loss_fn`` equals JAX's (flash off, its CPU default) within rtol
  1e-5, and so does the port's with kernel 11 forced on; the gradient of
  every leaf equals ``jax.grad``'s within atol 1e-5 + rtol 1e-4 (absolute
  against the largest entry of the leaf), with kernel 11 on or off;
* ``make_train_step``: one ``torch.optim.SGD`` step at lr 1 (the updated
  params are p - g) and five ``torch.optim.Adam`` steps equal
  ``optax.sgd`` / ``optax.adam`` under JAX's ``make_train_step``, losses
  within rtol 1e-5, params within atol 1e-5 (absolute) + rtol 1e-4, and
  Adam's moments (``exp_avg`` / ``exp_avg_sq`` against optax's mu / nu)
  within 1e-4 of the leaf's largest entry + rtol 1e-4 (they sum five steps'
  gradients at parameters that drifted apart within the above). Adam runs at eps 1e-6 on both sides: at
  the default 1e-8 an entry whose gradient is f32 noise around zero (seen:
  -2.5e-9 in a w_gate whose largest is 0.088) steps by a sizeable share of
  lr in the noise's direction, on either package;
* ``tts.loss_fn`` and its gradient equal JAX's on ``TTSConfig.tiny`` at
  the same tolerances (the vocoder's kernels compared in JAX's layout);
* ``DORA_SP_IMPL`` resolves at step construction; ring and Ulysses at sp 1
  are the dense forms.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dora_tpu.models import layers as JL
from dora_tpu.models import tts as jtts
from dora_tpu.models import vlm as jvlm
from dora_tpu_torch.models import tts as ttts
from dora_tpu_torch.models import vlm as tvlm
from dora_tpu_torch.ops import flash_attention as FA

CFG = jvlm.VLMConfig.tiny()
TCFG = tvlm.VLMConfig.tiny()
ATOL, RTOL = 1e-5, 1e-4  # grads: atol against the leaf's largest entry; params: atol absolute
MOMENT_ATOL = 1e-4  # Adam's moments after five steps, against the leaf's largest entry


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, atol=ATOL, rtol=RTOL, what="", relative=True):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30) if relative else 1.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale, err_msg=what)


def _walk(jtree, ttree, path=""):
    """(path, jax leaf, port leaf) over the JAX tree's leaves."""
    if isinstance(jtree, dict):
        for key in jtree:
            yield from _walk(jtree[key], ttree[key], f"{path}/{key}")
    else:
        yield path, jtree, ttree


# jitted: JAX's eager value_and_grad traces op by op, several times slower
_loss_and_grads = jax.jit(jax.value_and_grad(jvlm.loss_fn), static_argnums=1)
_loss = jax.jit(jvlm.loss_fn, static_argnums=1)


@pytest.fixture(scope="module")
def jparams():
    return jax.jit(jvlm.init_params, static_argnums=1)(jax.random.PRNGKey(0), CFG)


def _batch(seed, b=2, t=8):
    rng = np.random.default_rng(seed)
    return {"images": rng.uniform(size=(b, CFG.image_size, CFG.image_size, 3)).astype(np.float32),
            "tokens": rng.integers(0, CFG.vocab, (b, t)).astype(np.int32)}


def _port(jparams):
    params = tvlm.params_from_jax(jparams, device="cpu")
    for leaf in tvlm.param_leaves(params):
        leaf.requires_grad_(True)
    return params


# ---------------------------------------------------------------------------
# kernel 11's gradient
# ---------------------------------------------------------------------------


def _qkv(seed, shape, kv_heads=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal(shape).astype(np.float32)
    kv_shape = shape if kv_heads is None else (shape[0], kv_heads, *shape[2:])
    k = rng.standard_normal(kv_shape).astype(np.float32)
    v = rng.standard_normal(kv_shape).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    return q, k, v, g


SHAPES = [(1, 2, 16, 16), (2, 4, 33, 8), (1, 3, 64, 40)]


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("shape", SHAPES, ids=["t16", "t33", "t64d40"])
def test_flash_grad_matches_autograd_of_plain(shape, causal):
    q, k, v, g = _qkv(sum(shape) + causal, shape)
    ins = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = FA.flash_attention(*ins, causal=causal)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    (out * torch.from_numpy(g)).sum().backward()
    ref = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    want = FA.flash_attention_plain(*ref, causal=causal)
    (want * torch.from_numpy(g)).sum().backward()
    _close(out, want, what="out")
    for name, a, b in zip("qkv", ins, ref):
        _close(a.grad, b.grad, what=f"d{name}")


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_flash_grad_matches_jax_dense_gqa(causal):
    """GQA as layers passes it: k/v of 2 heads repeated to 4 before the
    call; the gradient reaches the 2 kv heads through the repeat."""
    q, k, v, g = _qkv(7 + causal, (2, 4, 24, 16), kv_heads=2)

    def jloss(q, k, v):
        kk, vv = jnp.repeat(k, 2, axis=1), jnp.repeat(v, 2, axis=1)
        mask = JL.causal_mask(24, 24) if causal else None
        return jnp.sum(JL.attention(q, kk, vv, mask) * g)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = FA.flash_attention(tq, tk.repeat_interleave(2, dim=1), tv.repeat_interleave(2, dim=1),
                             causal=causal)
    (out * torch.from_numpy(g)).sum().backward()
    for name, got, w in zip("qkv", (tq, tk, tv), want):
        _close(got.grad, w, what=f"d{name}")


def test_flash_without_grad_skips_the_function():
    q, k, v, _ = _qkv(3, (1, 2, 16, 16))
    ins = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    with torch.no_grad():
        out = FA.flash_attention(*ins, causal=True)
    assert out.grad_fn is None
    plain = FA.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=True)
    assert plain.grad_fn is None
    torch.testing.assert_close(out, plain, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# vlm.loss_fn and its gradient
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flash", ["0", "1"], ids=["dense", "kernel11"])
def test_loss_and_grads_match_jax(jparams, flash, monkeypatch):
    """JAX's value_and_grad with its flash kernel off (it has no backward);
    the port with kernel 11 on (the FlashAttention function) or off."""
    batch = _batch(1)
    monkeypatch.setenv("DORA_FLASH_ATTENTION", "0")
    want_loss, want_grads = _loss_and_grads(jparams, CFG, {k: jnp.asarray(v)
                                                           for k, v in batch.items()})
    monkeypatch.setenv("DORA_FLASH_ATTENTION", flash)
    params = _port(jparams)
    FA.reset_launches()
    loss = tvlm.loss_fn(params, TCFG, batch)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    for path, w, p in _walk(want_grads, params):
        assert p.grad is not None, path
        _close(p.grad, w, what=path)


def test_every_leaf_gets_a_nonzero_gradient(jparams, monkeypatch):
    """Nothing on the forward (an in-place write, no_grad, a data_ptr
    kernel) detaches a leaf: each has a finite gradient that is not all zero."""
    monkeypatch.setenv("DORA_FLASH_ATTENTION", "1")
    params = _port(jparams)
    tvlm.loss_fn(params, TCFG, _batch(2)).backward()
    for path, _, p in _walk(jparams, params):
        assert p.grad is not None and torch.isfinite(p.grad).all(), path
        assert p.grad.abs().max() > 0, path


def test_loss_sees_the_image_prefix(jparams):
    """The image prefix is context though never scored: another image moves
    the loss, which still equals JAX's."""
    params = tvlm.params_from_jax(jparams, device="cpu")
    batch = _batch(3, b=1, t=6)
    base = float(tvlm.loss_fn(params, TCFG, batch))
    other = dict(batch, images=batch["images"][:, ::-1].copy())
    assert float(tvlm.loss_fn(params, TCFG, other)) != base
    want = float(_loss(jparams, CFG, {k: jnp.asarray(v) for k, v in other.items()}))
    np.testing.assert_allclose(float(tvlm.loss_fn(params, TCFG, other)), want, rtol=1e-5)


# ---------------------------------------------------------------------------
# make_train_step against optax
# ---------------------------------------------------------------------------


def _jax_steps(jparams, optimizer, batch, steps):
    p = jax.tree.map(jnp.copy, jparams)
    state = optimizer.init(p)
    step = jvlm.make_train_step(CFG, optimizer)
    losses = []
    for _ in range(steps):
        p, state, loss = step(p, state, {k: jnp.asarray(v) for k, v in batch.items()})
        losses.append(float(loss))
    return p, state, losses


@pytest.mark.parametrize("which,steps", [("sgd", 1), ("adam", 5)])
def test_train_step_matches_optax(jparams, which, steps, monkeypatch):
    monkeypatch.setenv("DORA_FLASH_ATTENTION", "0")
    batch = _batch(4)
    if which == "sgd":
        jopt, topt = optax.sgd(1.0), functools.partial(torch.optim.SGD, lr=1.0)
    else:
        jopt = optax.adam(1e-3, eps=1e-6)
        topt = functools.partial(torch.optim.Adam, lr=1e-3, eps=1e-6)
    want, want_state, want_losses = _jax_steps(jparams, jopt, batch, steps)
    params = tvlm.params_from_jax(jparams, device="cpu")
    state = tvlm.init_opt_state(topt, params)
    step = tvlm.make_train_step(TCFG, topt)
    losses = []
    for _ in range(steps):
        out, state, loss = step(params, state, batch)
        assert out is params and loss.grad_fn is None
        losses.append(float(loss))
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    for path, w, p in _walk(want, params):
        _close(p, w, what=path, relative=False)
    if which == "adam":
        assert losses[-1] < losses[0]
        adam = want_state[0]
        for (path, mu, p), (_, nu, _) in zip(_walk(adam.mu, params), _walk(adam.nu, params)):
            assert state.state[p]["step"] == steps == int(adam.count)
            _close(state.state[p]["exp_avg"], mu, atol=MOMENT_ATOL, what=f"mu {path}")
            _close(state.state[p]["exp_avg_sq"], nu, atol=MOMENT_ATOL, what=f"nu {path}")


def test_train_step_builds_its_optimizer_and_refuses_a_stranger(jparams):
    params = tvlm.params_from_jax(jparams, device="cpu")
    opt = functools.partial(torch.optim.SGD, lr=0.1)
    step = tvlm.make_train_step(TCFG, opt)
    _, state, loss0 = step(params, None, _batch(5))
    assert isinstance(state, torch.optim.SGD) and torch.isfinite(loss0)
    _, _, loss1 = step(params, state, _batch(5))
    assert float(loss1) < float(loss0)
    stranger = opt([torch.zeros(3, requires_grad=True)])
    with pytest.raises(ValueError, match="opt_state"):
        step(params, stranger, _batch(5))


def test_sp_impl_resolves_at_construction(jparams, monkeypatch):
    """DORA_SP_IMPL is read when the step is built, as JAX reads it; on a
    one-rank mesh ring and Ulysses are the dense forms, so both give JAX's
    loss; an unknown name fails at the step."""
    from dora_tpu_torch.parallel import make_mesh

    mesh = make_mesh()
    assert mesh.shape == {"dp": 1, "tp": 1, "sp": 1}
    batch = _batch(6, t=16)
    want = float(_loss(jparams, CFG, {k: jnp.asarray(v) for k, v in batch.items()}))
    opt = functools.partial(torch.optim.SGD, lr=0.0)
    for impl in ("ring", "ulysses", "bogus"):
        monkeypatch.setenv("DORA_SP_IMPL", impl)
        step = tvlm.make_train_step(TCFG, opt, mesh=mesh, ring_axis="sp")
        monkeypatch.setenv("DORA_SP_IMPL", "ring")
        params = tvlm.params_from_jax(jparams, device="cpu")
        if impl == "bogus":
            with pytest.raises(ValueError, match="unknown sp_impl 'bogus'"):
                step(params, None, batch)
            continue
        _, _, loss = step(params, None, batch)
        np.testing.assert_allclose(float(loss), want, rtol=1e-5)


# ---------------------------------------------------------------------------
# tts.loss_fn
# ---------------------------------------------------------------------------


def test_tts_loss_and_grads_match_jax():
    cfg = jtts.TTSConfig.tiny()
    tcfg = ttts.TTSConfig.tiny()
    jp = jtts.init_params(jax.random.PRNGKey(3), cfg)
    rng = np.random.default_rng(8)
    batch = {"text": rng.integers(0, cfg.vocab, (2, cfg.max_text)).astype(np.int32),
             "style": rng.integers(0, cfg.n_styles, (2,)).astype(np.int32),
             "mel": rng.standard_normal((2, cfg.max_frames, cfg.n_mels)).astype(np.float32),
             "wave": rng.uniform(-1, 1, (2, cfg.max_samples)).astype(np.float32)}
    want_loss, want_grads = jax.jit(jax.value_and_grad(jtts.loss_fn), static_argnums=1)(
        jp, cfg, {k: jnp.asarray(v) for k, v in batch.items()})
    params = ttts.params_from_jax(jp, device="cpu")
    for leaf in tvlm.param_leaves(params):
        leaf.requires_grad_(True)
    loss = ttts.loss_fn(params, tcfg, batch)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    for path, w, p in _walk(want_grads, params):
        g = p.grad
        if path in ("/voc1", "/voc2", "/voc3"):  # back to lax.conv_transpose's layout
            g = g.flip(-1).permute(2, 1, 0)
        assert g is not None and g.abs().max() > 0, path
        _close(g, w, what=path)


def test_tts_sgd_steps_lower_the_loss():
    cfg = ttts.TTSConfig.tiny()
    params = ttts.init_params(cfg, seed=1, device="cpu")
    rng = np.random.default_rng(9)
    batch = {"text": rng.integers(0, cfg.vocab, (2, cfg.max_text)),
             "style": rng.integers(0, cfg.n_styles, (2,)),
             "mel": rng.standard_normal((2, cfg.max_frames, cfg.n_mels)).astype(np.float32),
             "wave": rng.uniform(-1, 1, (2, cfg.max_samples)).astype(np.float32)}
    opt = tvlm.init_opt_state(functools.partial(torch.optim.SGD, lr=0.05), params)
    losses = []
    for _ in range(5):
        opt.zero_grad()
        loss = ttts.loss_fn(params, cfg, batch)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    assert losses[-1] < losses[0], losses
