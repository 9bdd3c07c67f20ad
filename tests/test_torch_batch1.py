"""The port's dense-cache attention twins, unfused model, batch-1 decode and
speculation loop against dora_tpu's, on the CPU.

Kernels 8-10's plain twins (what ``attention_batch_step``,
``attention_step`` and ``attention_chunk_step`` run on CPU tensors) are held
against the JAX package's Pallas functions run as its own tests run them
here (the Pallas interpreter), in f32 on the same seeded inputs: outputs
within 1e-5 of their largest magnitude (f32 sums in another order; the
twins fold the current row the reference's way, not by reading it back),
written cache rows within 1e-5, every other cache value exactly unchanged.
On the tiny random ``transformers`` Qwen2 the port's ``forward`` gives the
JAX package's logits (1e-5 of the largest) and transformers' (1e-4: a
third implementation's op order), and ``generate`` and ``run_loop`` give
the JAX package's greedy tokens and pass counts exactly.
"""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_paged_engine import tiny_qwen2  # noqa: F401 (fixture)

D, H, KV, HD, S = 64, 4, 2, 16, 64


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, tol=1e-5):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-30))


def _weights(rng):
    """Seeded sublayer weights, quantized by the JAX package and handed to
    both sides: (jax args, port args) of (norm_w, wqkv, sqkv, bqkv, wo, swo)."""
    from dora_tpu.ops.int8_matmul import quantize_int8

    n_qkv = (H + 2 * KV) * HD
    wqkv = quantize_int8(jnp.asarray(rng.standard_normal((D, n_qkv)).astype(np.float32)))
    wo = quantize_int8(jnp.asarray(rng.standard_normal((H * HD, D)).astype(np.float32)))
    nw = rng.standard_normal(D).astype(np.float32)
    bqkv = rng.standard_normal(n_qkv).astype(np.float32)
    j = (jnp.asarray(nw), wqkv["int8"], wqkv["scale"], jnp.asarray(bqkv), wo["int8"], wo["scale"])
    return j, tuple(torch.from_numpy(np.array(a)) for a in j)


def _rope(positions):
    """Full-width rope rows [n, hd] at ``positions``, from the JAX package's
    tables and row helper, as both sides take them."""
    from dora_tpu.models import layers as JL
    from dora_tpu.ops import decode_block as JD

    cos_t, sin_t = JL.rope_table(S, HD)
    cr, sr = JD.rope_rows_at(cos_t, sin_t, jnp.asarray(positions, jnp.int32))
    return (cr, sr), (torch.from_numpy(np.array(cr)), torch.from_numpy(np.array(sr)))


def _unwritten_same(got, before, written):
    got, before = _np(got), _np(before)
    assert np.array_equal(got[~written], before[~written])


@pytest.mark.parametrize("residual", (True, False))
def test_batch_step_twin_matches_jax(residual):
    """Four rows: an idle one pinned at position 0, one mid-cache, one at
    the last row of its plane, one at 17."""
    from dora_tpu.ops import decode_block as JD
    from dora_tpu_torch.ops import decode_block as TD

    rng = np.random.default_rng(1)
    jw, tw = _weights(rng)
    positions = [0, 33, S - 1, 17]
    b = len(positions)
    x = rng.standard_normal((b, D)).astype(np.float32)
    kc = rng.standard_normal((b, KV, S, HD)).astype(np.float32)
    vc = rng.standard_normal((b, KV, S, HD)).astype(np.float32)
    (jcr, jsr), (tcr, tsr) = _rope(positions)
    kw = dict(heads=H, kv_heads=KV, head_dim=HD, residual=residual)
    want, jk, jv = JD.attention_batch_step(
        jnp.asarray(x), *jw[:4], jcr, jsr, jnp.asarray(kc), jnp.asarray(vc), *jw[4:],
        jnp.asarray(positions, jnp.int32), **kw)
    got, tk, tv = TD.attention_batch_step(
        torch.from_numpy(x), *tw[:4], tcr, tsr, torch.from_numpy(kc.copy()),
        torch.from_numpy(vc.copy()), *tw[4:], torch.tensor(positions, dtype=torch.int32), **kw)
    assert got.dtype == torch.float32
    _close(got, want)
    written = np.zeros((b, KV, S), bool)
    written[np.arange(b), :, positions] = True
    for g, w, before in ((tk, jk, kc), (tv, jv, vc)):
        _close(_np(g)[written], _np(w)[written])
        _unwritten_same(g, before, written)


@pytest.mark.parametrize("position,residual", [(0, True), (41, True), (S - 1, False)])
def test_step_twin_matches_jax(position, residual):
    from dora_tpu.ops import decode_block as JD
    from dora_tpu_torch.ops import decode_block as TD

    rng = np.random.default_rng(position + 2)
    jw, tw = _weights(rng)
    x = rng.standard_normal((1, D)).astype(np.float32)
    kc = rng.standard_normal((KV, S, HD)).astype(np.float32)
    vc = rng.standard_normal((KV, S, HD)).astype(np.float32)
    (jcr, jsr), (tcr, tsr) = _rope([position])
    kw = dict(heads=H, kv_heads=KV, head_dim=HD, residual=residual)
    want, jk, jv = JD.attention_step(jnp.asarray(x), *jw[:4], jcr, jsr, jnp.asarray(kc),
                                     jnp.asarray(vc), *jw[4:], position, **kw)
    got, tk, tv = TD.attention_step(torch.from_numpy(x), *tw[:4], tcr, tsr,
                                    torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy()),
                                    *tw[4:], position, **kw)
    _close(got, want)
    written = np.zeros((KV, S), bool)
    written[:, position] = True
    for g, w, before in ((tk, jk, kc), (tv, jv, vc)):
        _close(_np(g)[written], _np(w)[written])
        _unwritten_same(g, before, written)


@pytest.mark.parametrize("position,residual", [(0, True), (38, True), (S - 5, False)])
def test_chunk_step_twin_matches_jax(position, residual):
    """M = 5 rows (a k = 4 verify): at the cache start, mid-cache, and
    ending on the last row of the cache."""
    from dora_tpu.ops import decode_block as JD
    from dora_tpu_torch.ops import decode_block as TD

    m = 5
    rng = np.random.default_rng(position + 3)
    jw, tw = _weights(rng)
    x = rng.standard_normal((m, D)).astype(np.float32)
    kc = rng.standard_normal((KV, S, HD)).astype(np.float32)
    vc = rng.standard_normal((KV, S, HD)).astype(np.float32)
    (jcr, jsr), (tcr, tsr) = _rope(list(range(position, position + m)))
    kw = dict(heads=H, kv_heads=KV, head_dim=HD, residual=residual)
    want, jk, jv = JD.attention_chunk_step(jnp.asarray(x), *jw[:4], jcr, jsr, jnp.asarray(kc),
                                           jnp.asarray(vc), *jw[4:], position, **kw)
    got, tk, tv = TD.attention_chunk_step(torch.from_numpy(x), *tw[:4], tcr, tsr,
                                          torch.from_numpy(kc.copy()),
                                          torch.from_numpy(vc.copy()), *tw[4:], position, **kw)
    _close(got, want)
    written = np.zeros((KV, S), bool)
    written[:, position : position + m] = True
    for g, w, before in ((tk, jk, kc), (tv, jv, vc)):
        _close(_np(g)[written], _np(w)[written])
        _unwritten_same(g, before, written)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models(tiny_qwen2):  # noqa: F811
    """(jax cfg, jax float params, jax quantized params, port cfg, port float
    params, port quantized params) on the same weights."""
    from dora_tpu.models.hf import qwen2 as jq
    from dora_tpu_torch.models.hf import qwen2 as tq

    cfg, params = jq.load(tiny_qwen2, max_seq=64)
    os.environ["DORA_INT8_DECODE"] = "1"
    try:
        qparams = jq.quantize_decode(params, cfg)
    finally:
        os.environ.pop("DORA_INT8_DECODE", None)
    tcfg, tparams = tq.load(tiny_qwen2, max_seq=64, device="cpu")
    return cfg, params, qparams, tcfg, tparams, tq.params_from_jax(qparams, device="cpu")


def test_forward_matches_jax_and_transformers(tiny_qwen2, models):  # noqa: F811
    from transformers import Qwen2ForCausalLM

    from dora_tpu.models.hf import qwen2 as jq
    from dora_tpu_torch.models.hf import qwen2 as tq

    cfg, params, qparams, tcfg, tparams, tqparams = models
    rng = np.random.default_rng(7)
    ids = rng.integers(0, cfg.vocab, size=(2, 11)).astype(np.int32)
    got = tq.forward(tparams, tcfg, torch.from_numpy(ids))
    _close(got, jq.forward(params, cfg, jnp.asarray(ids)))
    hf = Qwen2ForCausalLM.from_pretrained(tiny_qwen2).eval()
    with torch.no_grad():
        _close(got, hf(torch.from_numpy(ids).long()).logits, 1e-4)
    # quantized: 22 rows take the int8 product, 3 x 12 = 36 the sidecar
    for shape in ((2, 11), (3, 12)):
        ids = rng.integers(0, cfg.vocab, size=shape).astype(np.int32)
        _close(tq.forward(tqparams, tcfg, torch.from_numpy(ids)),
               jq.forward(qparams, cfg, jnp.asarray(ids)))


def test_generate_matches_jax(models):
    """Prompts of 3, 12 and 37 tokens (37 rows take the sidecar in the
    prefill), 10 new tokens each, through the fused batch-1 pass; and 0 new
    tokens, where both return an empty [1, 0]."""
    from dora_tpu.models.hf import qwen2 as jq
    from dora_tpu_torch.models.hf import qwen2 as tq
    from dora_tpu_torch.ops import decode_block as TD

    cfg, _, qparams, tcfg, _, tqparams = models
    rng = np.random.default_rng(5)
    for n in (3, 12, 37):
        prompt = rng.integers(0, cfg.vocab, size=n).tolist()
        for max_new in (10, 0):
            want = np.asarray(jq.generate(qparams, cfg, jnp.asarray([prompt], jnp.int32),
                                          max_new))
            got = tq.generate(tqparams, tcfg, torch.tensor([prompt]), max_new)
            assert got.dtype == torch.int32
            assert tuple(got.shape) == want.shape == (1, max_new)
            assert got.tolist() == want.tolist()
    with pytest.raises(ValueError, match="exceeds max_seq"):
        tq.generate(tqparams, tcfg, torch.zeros((1, 60), dtype=torch.int32), 5)
    assert TD.launch_counts()["attention_step"] == 0  # CPU tensors ran the twins


def _spec_run(side, params, cfg, ids, max_new, body, adaptive):
    """Batch-1 speculation as the JAX package composes it: the prompt through
    ``prefill_padded``, then ``run_loop`` with ``verify`` over ``fused_step``
    at cache and rope position prompt + n_emitted - 1."""
    t = len(ids)
    if side == "jax":
        from dora_tpu.models import spec_decode as S_
        from dora_tpu.models.hf import qwen2 as Q

        first, caches, _ = Q.prefill_padded(params, cfg, jnp.asarray([ids], jnp.int32),
                                            jnp.asarray(t, jnp.int32))
        history = jnp.zeros((cfg.max_seq,), jnp.int32).at[:t].set(
            jnp.asarray(ids, jnp.int32)).at[t].set(first[0])
    else:
        from dora_tpu_torch.models import spec_decode as S_
        from dora_tpu_torch.models.hf import qwen2 as Q

        first, caches, _ = Q.prefill_padded(params, cfg, torch.tensor([ids], dtype=torch.int32), t)
        history = torch.zeros(cfg.max_seq, dtype=torch.int32)
        history[:t] = torch.tensor(ids, dtype=torch.int32)
        history[t] = first[0]

    def verify(chunk, n_emitted, caches):
        return Q.fused_step(params, cfg, chunk, caches, t + n_emitted - 1)

    tokens, passes, spec = S_.run_loop(
        caches=caches, history=history, hist_len=t + 1, first=first[0],
        max_new_tokens=max_new, seq=cfg.max_seq, verify=verify, adaptive=adaptive,
        return_stats=True, body=body)
    return np.asarray(tokens).tolist(), int(passes), int(spec)


@pytest.mark.parametrize("body,adaptive", [(1, False), (4, False), (1, True), (4, True)])
def test_run_loop_matches_jax(models, body, adaptive):
    """A prompt of a repeated motif, so drafts are accepted, rejected and,
    adaptive, gated: tokens, model passes and full k + 1 passes equal, and
    the tokens are ``generate``'s."""
    from dora_tpu_torch.models.hf import qwen2 as tq

    cfg, _, qparams, tcfg, _, tqparams = models
    rng = np.random.default_rng(2)  # drafts accepted: 9 passes for 16 tokens at body 1
    ids = rng.integers(0, cfg.vocab, size=5).tolist() * 3
    want = _spec_run("jax", qparams, cfg, ids, 16, body, adaptive)
    got = _spec_run("port", tqparams, tcfg, ids, 16, body, adaptive)
    assert got == want
    assert got[1] < 16  # some pass emitted more than one token
    assert got[0] == tq.generate(tqparams, tcfg, torch.tensor([ids]), 16).tolist()


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("b", [1, 2])
def test_generate_zero_new_tokens_matches_jax(models, quantized, b):
    """``generate`` at max_new_tokens 0, fused (quantized, one row) and
    unfused: an empty [B, 0] int32 on the prompt's device, as the JAX scan
    of length 0 returns; the max_seq check still comes first."""
    from dora_tpu.models.hf import qwen2 as jq
    from dora_tpu_torch.models.hf import qwen2 as tq

    cfg, params, qparams, tcfg, tparams, tqparams = models
    jp, tp = (qparams, tqparams) if quantized else (params, tparams)
    prompt = np.random.default_rng(6).integers(0, cfg.vocab, size=(b, 7)).astype(np.int32)
    want = np.asarray(jq.generate(jp, cfg, jnp.asarray(prompt), 0))
    got = tq.generate(tp, tcfg, torch.from_numpy(prompt), 0)
    assert got.dtype == torch.int32 and got.device == torch.device("cpu")
    assert tuple(got.shape) == want.shape == (b, 0)
    with pytest.raises(ValueError, match="exceeds max_seq"):
        tq.generate(tp, tcfg, torch.zeros((b, cfg.max_seq + 1), dtype=torch.int32), 0)


@pytest.mark.parametrize("body", [1, 4])
def test_run_loop_zero_new_tokens_matches_jax(models, body):
    """``run_loop`` at max_new_tokens 0: no pass runs, the tokens are an
    empty [1, 0] and the pass counts (1, 0) are the JAX loop's."""
    cfg, _, qparams, tcfg, _, tqparams = models
    ids = np.random.default_rng(2).integers(0, cfg.vocab, size=5).tolist() * 3
    want = _spec_run("jax", qparams, cfg, ids, 0, body, False)
    got = _spec_run("port", tqparams, tcfg, ids, 0, body, False)
    assert got == want == ([[]], 1, 0)


@pytest.mark.parametrize("body", [1, 4])
def test_run_loop_worst_case_matches_jax(models, monkeypatch, body):
    """DORA_SPEC_WORST_CASE set: both loops draft last + 1 + i (ids past the
    vocab clamp in both embeddings), so nearly every draft is rejected.
    Tokens, model passes and full k + 1 passes equal the JAX loop's, traced
    with the knob set (its pass count parts from the lookup's), and the
    tokens are still ``generate``'s."""
    from dora_tpu_torch.models.hf import qwen2 as tq

    cfg, _, qparams, tcfg, _, tqparams = models
    rng = np.random.default_rng(2)
    ids = rng.integers(0, cfg.vocab, size=5).tolist() * 3
    lookup = _spec_run("jax", qparams, cfg, ids, 16, body, False)
    monkeypatch.setenv("DORA_SPEC_WORST_CASE", "1")
    want = _spec_run("jax", qparams, cfg, ids, 16, body, False)
    got = _spec_run("port", tqparams, tcfg, ids, 16, body, False)
    assert got == want
    assert want[1] > 16 // 2 and want[1] > lookup[1]  # drafts rejected
    assert got[2] == got[1] - 1  # every counted pass is a full k + 1 pass
    assert got[0] == tq.generate(tqparams, tcfg, torch.tensor([ids]), 16).tolist()
