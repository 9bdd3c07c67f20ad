"""No serving knob is quietly ignored by the port: the int8-KV, LoRA and
int4 knobs reach the engine with the JAX package's meaning (the text model
reads ``DORA_INT4_DECODE`` and ``DORA_WEIGHT_BITS``, the VLM only
``DORA_INT4_DECODE``). ``DORA_PAGED_KV=0``
builds the dense engine, ``DORA_INT8_PURE`` drops the bf16 sidecars,
``DORA_FUSED_DECODE=0`` sends decode down the unfused blocks (and the dense
engine refuses it), and ``DORA_SPEC_BODY`` / ``DORA_SPEC_ADAPTIVE`` /
``DORA_SPEC_WORST_CASE`` reach ``run_loop``, each with the JAX package's
meaning."""

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
              "DORA_PREFILL_CHUNK", "DORA_PREFIX_CACHE_PAGES", "DORA_INT8_PURE",
              "DORA_FUSED_DECODE", "DORA_SPEC_BODY", "DORA_SPEC_ADAPTIVE",
              "DORA_SPEC_WORST_CASE"):
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def _same_tree(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _same_tree(a[k], b[k], f"{path}/{k}")
    else:
        assert a.dtype == b.dtype and torch.equal(a, b), path


@pytest.mark.parametrize("env", [{"DORA_INT4_DECODE": "1"}, {"DORA_WEIGHT_BITS": "4"}])
def test_int4_knobs_pick_int4_as_in_jax(clean_env, env):
    """Either knob quantizes every decode weight, the tied head included, to
    int4, byte for byte the tree params_from_jax makes of the JAX package's."""
    import jax
    import jax.numpy as jnp

    from dora_tpu.models.hf import qwen2 as jq
    from dora_tpu_torch.models.hf import qwen2 as tq

    cfg, params = _tiny()
    for k, v in env.items():
        clean_env.setenv(k, v)
    got = tq.quantize_decode(params, cfg)
    want = jq.quantize_decode(jax.tree.map(lambda t: jnp.asarray(t.numpy()), params),
                              jq.Qwen2Config(**cfg.__dict__))
    for w in ("wqkv", "wo", "w_gateup", "w_down"):
        assert set(got["blocks"]["0"][w]) == {"int4", "gscale", "bf16"}
    assert got["lm_head"]["int4"].shape == (cfg.dim // 2, cfg.vocab)
    _same_tree(got, tq.params_from_jax(want, device="cpu"))


@pytest.mark.parametrize("bits", ["4", "6"])
def test_vlm_reads_only_int4_decode_as_in_jax(clean_env, bits):
    """``DORA_WEIGHT_BITS`` is the text model's knob: at 4 and at 6 both
    packages' VLM ``quantize_decode`` give int8, the same bytes."""
    import jax

    from dora_tpu.models import vlm as jvlm
    from dora_tpu_torch.models import vlm as tvlm

    clean_env.setenv("DORA_WEIGHT_BITS", bits)
    jparams = jvlm.init_params(jax.random.PRNGKey(0), jvlm.VLMConfig.tiny())
    got = tvlm.quantize_decode(tvlm.params_from_jax(jparams, device="cpu"))
    assert set(got["blocks"]["0"]["wqkv"]) == {"int8", "scale", "bf16"}
    _same_tree(got, tvlm.params_from_jax(jvlm.quantize_decode(jparams), device="cpu"))


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


def test_paged_kv_0_builds_the_dense_engine(clean_env):
    from dora_tpu_torch.models.batch_engine import BatchEngine, PagedBatchEngine
    from dora_tpu_torch.models.hf import qwen2 as tq
    from dora_tpu_torch.nodehub.llm_server import make_engine

    cfg, params = _tiny()
    params = tq.quantize_decode(params, cfg)
    assert isinstance(make_engine(params, cfg, device="cpu"), PagedBatchEngine)
    clean_env.setenv("DORA_PAGED_KV", "0")
    dense = make_engine(params, cfg, device="cpu")
    assert isinstance(dense, BatchEngine) and dense.max_slots == 4
    assert dense.caches["1"]["k"].shape == (4, cfg.kv_heads, cfg.max_seq, cfg.head_dim)


def test_int8_pure_drops_the_sidecar(clean_env):
    from dora_tpu_torch.models.hf import qwen2 as tq

    cfg, params = _tiny()
    q = tq.quantize_decode(params, cfg)
    assert q["lm_head"]["bf16"].dtype == torch.bfloat16
    assert all("bf16" in q["blocks"]["0"][n] for n in ("wqkv", "wo", "w_gateup", "w_down"))
    clean_env.setenv("DORA_INT8_PURE", "1")
    q = tq.quantize_decode(params, cfg)
    assert "bf16" not in q["lm_head"]
    assert not any("bf16" in q["blocks"]["0"][n] for n in ("wqkv", "wo", "w_gateup", "w_down"))


def test_fused_decode_0_takes_the_unfused_path(clean_env, monkeypatch):
    """``generate`` then runs every decode step through the unfused blocks,
    where each product is the int8 product of one row (kernel 7 at M = 1
    on the card), with the fused path's tokens; the dense engine refuses."""
    from dora_tpu_torch.models import vlm
    from dora_tpu_torch.models.hf import qwen2 as tq
    from dora_tpu_torch.ops import decode_block as DB
    from dora_tpu_torch.ops import int8_matmul as IM

    cfg, params = _tiny()
    params = tq.quantize_decode(params, cfg)
    prompt = torch.tensor([[3, 1, 4, 1, 5]])
    fused = tq.generate(params, cfg, prompt, 4)
    assert vlm.fused_decode_ready(params) and not vlm.fused_decode_ready(params, 2)
    rows = []
    inner = IM.int8_matmul

    def counting(x, q, s):
        rows.append(x.numel() // x.shape[-1])
        return inner(x, q, s)

    monkeypatch.setattr(IM, "int8_matmul", counting)
    monkeypatch.setattr(DB, "attention_step", None)  # the fused pass would fail
    clean_env.setenv("DORA_FUSED_DECODE", "0")
    assert not vlm.fused_decode_ready(params) and not vlm.fused_batch_ready(params)
    unfused = tq.generate(params, cfg, prompt, 4)
    assert unfused.tolist() == fused.tolist()
    per_pass = 4 * cfg.layers + 1  # wqkv, wo, w_gateup, w_down per layer, then the head
    assert rows == [5] * (per_pass - 1) + [1] + [1] * (3 * per_pass)
    with pytest.raises(ValueError, match="fused decode tier"):
        tq.make_batch_engine(params, cfg, device="cpu")


def _spec_calls(**env):
    """run_loop over a verify that never agrees with a lookup draft (greedy
    = chunk + 1): the widths of its verify calls and its pass counts."""
    from dora_tpu_torch.models import spec_decode as SD

    widths = []

    def verify(chunk, n_emitted, caches):
        widths.append(chunk.shape[1])
        return (chunk[0] + 1) % 64, caches

    history = torch.zeros(32, dtype=torch.int32)
    history[:4] = torch.tensor([9, 2, 6, 3])
    tokens, passes, spec = SD.run_loop(caches=None, history=history, hist_len=4, first=3,
                                       max_new_tokens=6, seq=32, verify=verify,
                                       return_stats=True)
    assert tokens.tolist() == [[3, 4, 5, 6, 7, 8]]
    return widths, passes, spec


def test_spec_body_and_adaptive_reach_run_loop(clean_env):
    """One token a pass: DORA_SPEC_BODY=4 (the default) runs 2 bodies of 4
    passes, the last 3 past max_new and uncounted, DORA_SPEC_BODY=1 runs
    5; DORA_SPEC_ADAPTIVE=1 drops to one-token passes once the acceptance
    EMA falls below 0.3 (1 -> 0.5 -> 0.25 after two rejected chunks) and
    probes a chunk again when it has recovered (0.28, then 0.31)."""
    from dora_tpu_torch.models import spec_decode as SD

    assert SD.body_passes() == 4
    assert _spec_calls() == ([5] * 8, 6, 5)
    clean_env.setenv("DORA_SPEC_BODY", "1")
    assert SD.body_passes() == 1 and SD.fitting_body_passes(10, 10, 64) == 1
    assert _spec_calls() == ([5] * 5, 6, 5)
    clean_env.setenv("DORA_SPEC_ADAPTIVE", "1")
    assert _spec_calls() == ([5, 5, 1, 1, 5], 6, 3)
    clean_env.setenv("DORA_SPEC_BODY", "4")
    assert SD.fitting_body_passes(10, 30, 64) == 4 and SD.fitting_body_passes(10, 40, 64) == 2
    with pytest.raises(ValueError, match="speculation headroom"):
        SD.check_headroom(40, 20, 64, "prompt")


@pytest.mark.parametrize("value", ["1", "0", "yes"])
def test_spec_worst_case_replaces_the_lookup(clean_env, value):
    """DORA_SPEC_WORST_CASE, any non-empty value as in the JAX loop (even
    "0"), drafts last + 1 + i in place of the n-gram lookup. Over the
    verify whose greedy is chunk + 1 that run is exactly what it
    continues: one pass of 4 accepted drafts and a bonus token emits all 5,
    where the lookup's drafts take 5 passes. An empty value is off."""
    assert _spec_calls() == ([5] * 8, 6, 5)
    clean_env.setenv("DORA_SPEC_WORST_CASE", value)
    assert _spec_calls() == ([5] * 4, 2, 1)
    clean_env.setenv("DORA_SPEC_WORST_CASE", "")
    assert _spec_calls() == ([5] * 8, 6, 5)
