"""The port's int8 quantizer against dora_tpu's: payloads and scales are
byte-identical (both round half to even), fused layouts included."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dora_tpu.ops import int8_matmul as J
from dora_tpu_torch.ops import int8_matmul as T


def _same(t: torch.Tensor, j) -> None:
    j = np.asarray(j)
    got = t.numpy()
    assert got.dtype == j.dtype and got.shape == j.shape
    assert got.tobytes() == j.tobytes()


@pytest.mark.parametrize("shape", [(64, 48), (33, 7), (128, 300)])
def test_quantize_int8_is_byte_identical(shape):
    rng = np.random.default_rng(shape[0] * shape[1])
    w = (rng.standard_normal(shape) * rng.uniform(0.01, 3.0, shape[1])).astype(np.float32)
    w[:, 0] = 0.0  # an all-zero column takes the 1e-12 scale floor
    j = J.quantize_int8(jnp.asarray(w))
    t = T.quantize_int8(torch.from_numpy(w))
    _same(t["int8"], j["int8"])
    _same(t["scale"], j["scale"])
    np.testing.assert_array_equal(
        T.dequantize(t).numpy(), np.asarray(J.dequantize(j))
    )


def test_quantize_int8_rounds_half_to_even():
    # Column max 127 makes the scale exactly 1, so w/scale hits the halves.
    w = np.array([[127.0, 127.0], [2.5, -3.5], [0.5, 1.5], [-0.5, 126.5]], np.float32)
    t = T.quantize_int8(torch.from_numpy(w))
    assert t["int8"].tolist() == [[127, 127], [2, -4], [0, 2], [0, 126]]
    _same(t["int8"], J.quantize_int8(jnp.asarray(w))["int8"])


def test_quantize_tree_fused_layout_is_byte_identical():
    rng = np.random.default_rng(7)
    d, f, kv = 32, 48, 8

    def w(*s):
        return rng.standard_normal(s).astype(np.float32)

    block = {
        "attn_norm": w(d), "wq": w(d, d), "wk": w(d, kv), "wv": w(d, kv),
        "bq": w(d), "bv": w(kv), "wo": w(d, d), "ffn_norm": w(d),
        "w_gate": w(d, f), "w_up": w(d, f), "w_down": w(f, d),
    }
    tree = {"0": block, "1": dict(block)}
    j = J.quantize_tree(
        {k: {n: jnp.asarray(a) for n, a in b.items()} for k, b in tree.items()},
        keep_bf16=False,
    )
    t = T.quantize_tree(
        {k: {n: torch.from_numpy(a) for n, a in b.items()} for k, b in tree.items()},
        keep_bf16=False,
    )
    for layer in ("0", "1"):
        assert set(t[layer]) == set(j[layer])
        assert {"wqkv", "bqkv", "w_gateup", "wo", "w_down"} <= set(t[layer])
        assert "b_gateup" not in t[layer]
        for name, jv in j[layer].items():
            tv = t[layer][name]
            if isinstance(jv, dict):
                assert set(tv) == set(jv)
                for k in jv:
                    _same(tv[k], jv[k])
            else:
                _same(tv, jv)  # norms, and the zero-filled bk segment of bqkv
    # already-quantized dicts pass through untouched
    again = T.quantize_tree(t)
    assert again["0"]["wqkv"]["int8"] is t["0"]["wqkv"]["int8"]
