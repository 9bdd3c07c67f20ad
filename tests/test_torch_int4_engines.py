"""The port's engines on int4 weights against dora_tpu's, on the CPU.

A seeded random Qwen2 at dim 256, 2 layers, 4 / 2 heads of 64 and ffn 512
(two groups of 128 on every product's K), quantized by the JAX package under
``DORA_WEIGHT_BITS=4`` and carried over by ``params_from_jax``; the port's
own ``quantize_decode`` gives the same bytes. Greedy tokens equal the JAX
package's exactly, in f32 on both sides (the port's plain versions here, the
Pallas kernels' int4 branch in interpret mode there), for the paged engine
(spec off, ``spec_k`` 4, and int8 KV pages with one LoRA adapter), the dense
engine, batch-1 ``generate`` and ``run_loop``. The self-contained VLM under
``DORA_INT4_DECODE=1``: its fused tier gives the tokens of the unfused path
on the dequantized weights and of the JAX package, and
``generate_speculative`` those of ``generate``, as tests/test_ops.py holds
the JAX package's.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_batch1 import _spec_run

MAX_NEW = 10


def _drain(streams: dict, events) -> None:
    for rid, token, _done in events:
        streams[rid].append(int(token))


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(jax cfg, jax int4 params, port cfg, port int4 params, lora dir)."""
    from dora_tpu.models.hf import qwen2 as jq
    from dora_tpu_torch.models.hf import qwen2 as tq

    tcfg = tq.Qwen2Config(vocab=256, dim=256, layers=2, heads=4, kv_heads=2, ffn=512,
                          rope_theta=10000.0, norm_eps=1e-6, tie_embeddings=False,
                          max_seq=64)
    cfg = jq.Qwen2Config(**tcfg.__dict__)
    fparams = tq.random_params(tcfg, seed=3, std=0.08, device="cpu")
    jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), fparams)
    mp = pytest.MonkeyPatch()
    mp.setenv("DORA_WEIGHT_BITS", "4")
    try:
        jquant = jq.quantize_decode(jparams, cfg)
        tquant = tq.quantize_decode(fparams, tcfg)
    finally:
        mp.undo()
    lora_dir = tmp_path_factory.mktemp("int4-adapters")
    rng = np.random.default_rng(7)
    np.savez(lora_dir / "ta.npz",
             **{f"a_{i}": rng.normal(size=(256, 8)).astype(np.float32) * 0.3 for i in range(2)},
             **{f"b_{i}": rng.normal(size=(8, 256)).astype(np.float32) * 0.3 for i in range(2)})
    return cfg, jquant, tcfg, tq.params_from_jax(jquant, device="cpu"), tquant, str(lora_dir)


def test_quantize_decode_int4_gives_jax_bytes(both):
    """The port's own int4 tree is, leaf for leaf and byte for byte, the one
    ``params_from_jax`` makes of the JAX package's (uint8 nibbles, f32
    group scales, bf16 sidecars)."""
    _, jquant, _, tparams, tquant, _ = both
    assert tparams["blocks"]["0"]["w_down"]["int4"].shape == (256, 256)
    assert tparams["lm_head"]["gscale"].shape == (2, 256)

    def same(a, b, path=""):
        if isinstance(a, dict):
            assert set(a) == set(b), path
            for k in a:
                same(a[k], b[k], f"{path}/{k}")
        else:
            assert a.dtype == b.dtype and torch.equal(a, b), path

    same(tquant, tparams)


def _prompts(cfg, seed=5, plens=(3, 12, 37, 5)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, size=n).tolist() for n in plens]


def _drive_paged(engine, prompts, adapters=None):
    """Staggered admissions: one stream decodes alone, then the rest join
    (a 37-token prompt over five 8-token chunks among them)."""
    adapters = adapters or [None] * len(prompts)
    streams = {f"r{i}": [] for i in range(len(prompts))}

    def submit(i):
        if adapters[i] is None:
            engine.submit(f"r{i}", prompts[i], MAX_NEW)
        else:
            engine.submit(f"r{i}", prompts[i], MAX_NEW, adapter=adapters[i])

    submit(0)
    for _ in range(2):
        _drain(streams, engine.step())
    for i in range(1, len(prompts)):
        submit(i)
    for _ in range(300):
        if not engine.active:
            break
        _drain(streams, engine.step())
    assert engine.active == 0
    assert all(len(s) == MAX_NEW for s in streams.values())
    return streams


@pytest.mark.parametrize("spec_k", (0, 4))
def test_paged_engine_int4_matches_jax(both, spec_k):
    from dora_tpu.models.hf import qwen2 as jq
    from dora_tpu_torch.models.hf import qwen2 as tq

    cfg, jquant, tcfg, tparams, _, _ = both
    prompts = _prompts(cfg)
    kw = dict(max_slots=4, page_size=8, chunk=8, window=4, spec_k=spec_k)
    want = _drive_paged(jq.make_paged_engine(jquant, cfg, **kw), prompts)
    port = tq.make_paged_engine(tparams, tcfg, device="cpu", **kw)
    got = _drive_paged(port, prompts)
    port.check_invariants()
    assert got == want


def test_paged_engine_int4_int8kv_lora_matches_jax(both):
    """int8 KV pages and one adapter beside the int4 base weights: the
    adapter's delta is added after each layer's MLP whatever the base
    format."""
    from dora_tpu.models.hf import qwen2 as jq
    from dora_tpu_torch.models.hf import qwen2 as tq

    cfg, jquant, tcfg, tparams, _, lora_dir = both
    prompts = _prompts(cfg, seed=6, plens=(4, 9, 6))
    adapters = ["ta", None, "ta"]
    kw = dict(max_slots=4, page_size=8, chunk=8, window=4, kv_int8=True, lora_dir=lora_dir)
    want = _drive_paged(jq.make_paged_engine(jquant, cfg, **kw), prompts, adapters)
    port = tq.make_paged_engine(tparams, tcfg, device="cpu", **kw)
    got = _drive_paged(port, prompts, adapters)
    assert got == want
    base = _drive_paged(tq.make_paged_engine(tparams, tcfg, device="cpu", max_slots=4,
                                             page_size=8, chunk=8, window=4, kv_int8=True),
                        prompts)
    assert base["r1"] == got["r1"] and base["r0"] != got["r0"]  # the adapter steers


def test_dense_engine_int4_matches_jax(both):
    from dora_tpu.models.hf import qwen2 as jq
    from dora_tpu_torch.models.hf import qwen2 as tq

    cfg, jquant, tcfg, tparams, _, _ = both
    prompts = _prompts(cfg, seed=8, plens=(5, 14, 7))

    def drive(engine):
        out = {0: [int(engine.submit(0, prompts[0], MAX_NEW)[0])]}  # prefill's token
        _drain(out, engine.step())
        for i in range(1, len(prompts)):
            out[i] = [int(engine.submit(i, prompts[i], MAX_NEW)[0])]
        for _ in range(100):
            if not engine.active:
                break
            _drain(out, engine.step())
        return out

    want = drive(jq.make_batch_engine(jquant, cfg, max_slots=3))
    got = drive(tq.make_batch_engine(tparams, tcfg, max_slots=3, device="cpu"))
    assert got == want and all(len(s) == MAX_NEW for s in got.values())


def test_generate_and_run_loop_int4_match_jax(both):
    """Batch-1 ``generate`` (kernel 9's plain version a step) on two prompts,
    and ``run_loop`` over ``fused_step`` (kernel 10's) on a repeated motif:
    tokens and model passes equal, and the loop's tokens are
    ``generate``'s."""
    from dora_tpu.models.hf import qwen2 as jq
    from dora_tpu_torch.models.hf import qwen2 as tq

    cfg, jquant, tcfg, tparams, _, _ = both
    for prompt in _prompts(cfg, seed=9, plens=(4, 33)):
        want = np.asarray(jq.generate(jquant, cfg, jnp.asarray([prompt], jnp.int32), MAX_NEW))
        got = tq.generate(tparams, tcfg, torch.tensor([prompt]), MAX_NEW)
        assert got.tolist() == want.tolist()
    ids = _prompts(cfg, seed=2, plens=(5,))[0] * 3
    want = _spec_run("jax", jquant, cfg, ids, 16, 1, False)
    got = _spec_run("port", tparams, tcfg, ids, 16, 1, False)
    assert got == want
    assert got[0] == tq.generate(tparams, tcfg, torch.tensor([ids]), 16).tolist()


def test_vlm_int4_fused_matches_unfused_speculative_and_jax(monkeypatch):
    """``DORA_INT4_DECODE=1`` on ``VLMConfig.tiny``: the port's tree equals
    the JAX package's byte for byte; the fused tier's tokens equal the
    unfused path's on the dequantized weights and the JAX package's, and
    ``generate_speculative`` equals ``generate``."""
    from dora_tpu.models import vlm as jvlm
    from dora_tpu_torch.models import vlm as tvlm

    monkeypatch.setenv("DORA_INT4_DECODE", "1")
    for knob in ("DORA_FUSED_DECODE", "DORA_INT8_PURE", "DORA_WEIGHT_BITS"):
        monkeypatch.delenv(knob, raising=False)
    cfg = jvlm.VLMConfig.tiny()
    jparams = jvlm.init_params(jax.random.PRNGKey(0), cfg)
    jquant = jvlm.quantize_decode(jparams)
    tquant = tvlm.params_from_jax(jquant, device="cpu")
    own = tvlm.quantize_decode(tvlm.params_from_jax(jparams, device="cpu"))
    assert torch.equal(own["blocks"]["1"]["w_gateup"]["int4"],
                       tquant["blocks"]["1"]["w_gateup"]["int4"])
    assert torch.equal(own["lm_head"]["gscale"], tquant["lm_head"]["gscale"])
    assert tvlm.fused_decode_ready(tquant)
    rng = np.random.default_rng(1)
    image = rng.uniform(size=(1, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    prompt = rng.integers(0, cfg.vocab, size=(1, 5)).astype(np.int32)
    timg, tids = torch.from_numpy(image), torch.from_numpy(prompt)
    tcfg = tvlm.VLMConfig.tiny()
    fused = tvlm.generate(tquant, tcfg, timg, tids, 8)
    want = np.asarray(jvlm.generate(jquant, cfg, jnp.asarray(image), jnp.asarray(prompt), 8))
    np.testing.assert_array_equal(fused.numpy(), want)
    monkeypatch.setenv("DORA_FUSED_DECODE", "0")
    np.testing.assert_array_equal(tvlm.generate(tquant, tcfg, timg, tids, 8).numpy(),
                                  fused.numpy())
    monkeypatch.delenv("DORA_FUSED_DECODE")
    spec, _ = tvlm.generate_speculative(tquant, tcfg, timg, tids, 8)
    np.testing.assert_array_equal(spec.numpy(), fused.numpy())
