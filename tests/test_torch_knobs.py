"""No serving knob is quietly ignored by the port: the int8-KV and LoRA
knobs reach the engine with the JAX package's meaning, and the int4 knobs,
whose path is not ported, raise instead of serving int8."""

from __future__ import annotations

import numpy as np
import pytest
import torch


def _tiny():
    from dora_tpu_torch.models.hf import qwen2 as tq

    cfg = tq.Qwen2Config(vocab=64, dim=32, layers=2, heads=2, kv_heads=1, ffn=64,
                         rope_theta=10000.0, norm_eps=1e-6, tie_embeddings=True,
                         max_seq=64)
    return cfg, tq.random_params(cfg, seed=0, device="cpu")


@pytest.fixture
def clean_env(monkeypatch):
    for k in ("DORA_WEIGHT_BITS", "DORA_INT4_DECODE", "DORA_KV_INT8", "DORA_LORA_DIR",
              "DORA_LORA_MAX_RESIDENT", "DORA_LORA_RANK", "DORA_PAGED_KV", "DORA_SPEC_K",
              "DORA_PREFIX_CACHE", "DORA_MULTISTEP_K", "DORA_BATCH_SLOTS", "DORA_PAGE_SIZE",
              "DORA_PREFILL_CHUNK", "DORA_PREFIX_CACHE_PAGES"):
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


@pytest.mark.parametrize("env", [{"DORA_INT4_DECODE": "1"}, {"DORA_WEIGHT_BITS": "4"}])
def test_int4_knobs_raise_until_int4_is_ported(clean_env, env):
    from dora_tpu_torch.models.hf import qwen2 as tq

    cfg, params = _tiny()
    for k, v in env.items():
        clean_env.setenv(k, v)
    with pytest.raises(NotImplementedError, match="int4"):
        tq.quantize_decode(params, cfg)


def test_weight_bits_other_than_4_or_8_raise_as_in_jax(clean_env):
    from dora_tpu.models.hf import qwen2 as jq
    from dora_tpu_torch.models.hf import qwen2 as tq

    cfg, params = _tiny()
    clean_env.setenv("DORA_WEIGHT_BITS", "6")
    with pytest.raises(ValueError) as port_err:
        tq.quantize_decode(params, cfg)
    with pytest.raises(ValueError) as jax_err:
        jq.quantize_decode({"blocks": {}, "embed": np.zeros((4, 2), np.float32)}, cfg)
    assert str(port_err.value) == str(jax_err.value)
    clean_env.setenv("DORA_WEIGHT_BITS", "8")
    q = tq.quantize_decode(params, cfg)
    assert q["blocks"]["0"]["wqkv"]["int8"].dtype == torch.int8


def test_kv_int8_and_lora_knobs_reach_the_engine(clean_env, tmp_path):
    """llm_server.make_engine with DORA_KV_INT8 builds int8 pools in the fp
    pool's byte budget; DORA_LORA_DIR / DORA_LORA_MAX_RESIDENT /
    DORA_LORA_RANK build the adapter pool, and an adapter routes tokens."""
    from dora_tpu_torch.models.hf import qwen2 as tq
    from dora_tpu_torch.nodehub.llm_server import make_engine, serve_prompts

    cfg, params = _tiny()
    params = tq.quantize_decode(params, cfg)
    base = make_engine(params, cfg, device="cpu")
    assert base.kv_dtype == "fp" and base.lora is None

    rng = np.random.default_rng(3)
    for name, rank in (("t0", 2), ("t1", 4)):
        np.savez(tmp_path / f"{name}.npz",
                 **{f"a_{i}": rng.normal(size=(32, rank)).astype(np.float32) for i in range(2)},
                 **{f"b_{i}": rng.normal(size=(rank, 32)).astype(np.float32) for i in range(2)})
    clean_env.setenv("DORA_KV_INT8", "1")
    clean_env.setenv("DORA_LORA_DIR", str(tmp_path))
    clean_env.setenv("DORA_LORA_MAX_RESIDENT", "3")
    clean_env.setenv("DORA_LORA_RANK", "6")
    eng = make_engine(params, cfg, device="cpu")
    assert eng.kv_dtype == "int8" and eng.pools["0"]["ks"].shape[0] == eng.allocator.num_pages
    budget = base.allocator.num_pages * tq.page_pool_bytes(cfg, 16, torch.float32)
    assert eng.allocator.num_pages == budget // tq.page_pool_bytes(cfg, 16, kv_int8=True)
    assert eng.lora.max_resident == 3 and eng.lora.known == {"t0", "t1"}
    assert eng.lora.state()["a"].shape == (4, 2, 32, 6)
    out, _ = serve_prompts(eng, [[1, 2, 3], [1, 2, 3]], 6, adapters=["t1", None])
    assert eng.lora.loads == 1 and len(out[0]) == len(out[1]) == 6
