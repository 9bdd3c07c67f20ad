"""The port's int8 product (kernel 7's plain twin) and the quantized-product
dispatch against dora_tpu's, on the CPU.

The twin ``int8_matmul_plain`` (what ``int8_matmul`` runs on a CPU tensor)
is held against the JAX package's Pallas ``int8_matmul`` run as its own
tests run it here (the Pallas interpreter), both in f32, at M in {1, 8, 33,
64} with odd K and N: within rtol 1e-5 and 1e-5 of the output's largest
magnitude (both sum exact f32 products of the same int8 values, in another
order). The quantized tree with its bf16 sidecars is byte-identical, and
``layers.matmul`` sends M = 32 rows to the int8 product and M = 33 to the
sidecar, as the JAX package's does.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch


def _bits(a) -> np.ndarray:
    """The bytes of a JAX array or tensor, bf16 included, as a numpy array."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("m,k,n", [(1, 37, 53), (8, 129, 70), (33, 64, 131), (64, 95, 257)])
def test_int8_matmul_twin_matches_jax(m, k, n):
    from dora_tpu.ops import int8_matmul as J
    from dora_tpu_torch.ops import int8_matmul as T

    rng = np.random.default_rng(m * 1000 + k)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    jw = J.quantize_int8(jnp.asarray(w))
    want = np.asarray(J.int8_matmul(jnp.asarray(x), jw["int8"], jw["scale"]))
    tw = T.quantize_int8(torch.from_numpy(w))
    got = T.int8_matmul(torch.from_numpy(x), tw["int8"], tw["scale"])
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    assert T.int8_matmul.launches == 0  # a CPU tensor runs the twin, no kernel


def test_int8_matmul_keeps_leading_axes():
    from dora_tpu.ops import int8_matmul as J
    from dora_tpu_torch.ops import int8_matmul as T

    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 40)).astype(np.float32)
    w = rng.standard_normal((40, 24)).astype(np.float32)
    jw = J.quantize_int8(jnp.asarray(w))
    want = np.asarray(J.int8_matmul(jnp.asarray(x), jw["int8"], jw["scale"]))
    tw = T.quantize_int8(torch.from_numpy(w))
    got = T.int8_matmul(torch.from_numpy(x), tw["int8"], tw["scale"]).numpy()
    assert got.shape == (2, 3, 24)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_quantize_tree_with_sidecars_is_byte_identical():
    """Payloads, scales, the fused biases and every bf16 sidecar, bit for
    bit, for a block with q/k/v biases and a tied head quantized from the
    embedding transpose."""
    from dora_tpu.ops import int8_matmul as J
    from dora_tpu_torch.ops import int8_matmul as T

    rng = np.random.default_rng(11)
    d, f, kv = 32, 48, 8

    def w(*s):
        return rng.standard_normal(s).astype(np.float32)

    block = {"attn_norm": w(d), "wq": w(d, d), "wk": w(d, kv), "wv": w(d, kv),
             "bq": w(d), "bk": w(kv), "bv": w(kv), "wo": w(d, d), "ffn_norm": w(d),
             "w_gate": w(d, f), "w_up": w(d, f), "w_down": w(f, d)}
    embed = w(64, d)
    j = J.quantize_tree({"0": {n: jnp.asarray(a) for n, a in block.items()},
                         "lm_head": jnp.asarray(embed).T}, keep_bf16=True)
    t = T.quantize_tree({"0": {n: torch.from_numpy(a) for n, a in block.items()},
                         "lm_head": torch.from_numpy(embed).T}, keep_bf16=True)
    assert set(t) == set(j) and set(t["0"]) == set(j["0"])
    pairs = [(t["lm_head"], j["lm_head"])] + [(t["0"][n], j["0"][n]) for n in j["0"]]
    n_sidecars = 0
    for tv, jv in pairs:
        if not isinstance(jv, dict):
            np.testing.assert_array_equal(_bits(tv), _bits(jv))
            continue
        assert set(tv) == set(jv) == {"int8", "scale", "bf16"}
        for key in jv:
            assert tuple(tv[key].shape) == tuple(jv[key].shape)
            np.testing.assert_array_equal(_bits(tv[key]), _bits(jv[key]))
        n_sidecars += 1
    assert n_sidecars == 5  # wqkv, wo, w_gateup, w_down, lm_head


@pytest.mark.parametrize("m,route", [(32, "int8"), (33, "bf16")])
def test_matmul_dispatch_at_32_and_33_rows(monkeypatch, m, route):
    """M <= 32 rows take the int8 product, larger M the sidecar; the values
    match the JAX package's ``layers.matmul`` on the same weight (rtol
    1e-5: f32 sums of the same products, in another order)."""
    from dora_tpu.models import layers as JL
    from dora_tpu.ops import int8_matmul as J
    from dora_tpu_torch.models import layers as TL
    from dora_tpu_torch.ops import int8_matmul as T

    rng = np.random.default_rng(m)
    x = rng.standard_normal((1, m, 48)).astype(np.float32)
    w = rng.standard_normal((48, 40)).astype(np.float32)
    want = np.asarray(JL.matmul(jnp.asarray(x), J.quantize_int8(jnp.asarray(w), keep_bf16=True)))
    calls = []
    inner = T.int8_matmul

    def counting(x, q, s):
        calls.append(tuple(x.shape))
        return inner(x, q, s)

    monkeypatch.setattr(T, "int8_matmul", counting)
    got = TL.matmul(torch.from_numpy(x), T.quantize_int8(torch.from_numpy(w), keep_bf16=True))
    assert calls == ([(1, m, 48)] if route == "int8" else [])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    # without a sidecar every M takes the int8 product (DORA_INT8_PURE)
    calls.clear()
    TL.matmul(torch.from_numpy(x), T.quantize_int8(torch.from_numpy(w)))
    assert calls == [(1, m, 48)]
