"""The limits the port's kernels keep, refused when an engine is built.

The attention kernels take head_dim 64 or 128, whole query groups and pool
pages that are multiples of 16 rows; the LoRA kernel ranks up to 256 and
flash attention head_dims that are multiples of 8 up to 128. Every shape
of the Qwen2 family at 0.5B, 1.5B, 7B and 72B (14/2, 12/2, 28/4 and 64/8
heads), page 16 and 32, and ranks up to 256 is inside them. A model
outside them is refused, each limit named, by ``make_paged_engine``,
``make_batch_engine`` (so ``llm_server.make_engine``), ``make_lora_pool``,
``qwen2.generate``, ``vlm.generate`` and ``vlm.generate_speculative``
before any work when they would serve on the card; on the CPU the plain
versions take every shape, so the same calls serve there.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from dora_tpu_torch.models import vlm as tvlm
from dora_tpu_torch.models.hf import qwen2 as tq
from dora_tpu_torch.ops import decode_block as DB
from dora_tpu_torch.ops import flash_attention as FA
from dora_tpu_torch.ops import lora as LO


def _cfg(**kw):
    base = dict(vocab=64, dim=160, layers=1, heads=2, kv_heads=1, ffn=64,
                rope_theta=10000.0, norm_eps=1e-6, tie_embeddings=False, max_seq=64)
    return tq.Qwen2Config(**{**base, **kw})


@pytest.fixture()
def quantized(monkeypatch):
    for knob in ("DORA_FUSED_DECODE", "DORA_INT4_DECODE", "DORA_WEIGHT_BITS",
                 "DORA_INT8_PURE", "DORA_LORA_DIR", "DORA_SPEC_K", "DORA_KV_INT8"):
        monkeypatch.delenv(knob, raising=False)

    def make(cfg):
        return tq.quantize_decode(tq.random_params(cfg, seed=0, device="cpu"), cfg)

    return make


@pytest.mark.parametrize("heads,kv_heads,head_dim", [
    (14, 2, 64), (12, 2, 128), (28, 4, 128), (64, 8, 128), (20, 2, 64)])
def test_qwen2_family_shapes_are_inside_the_kernels(heads, kv_heads, head_dim):
    for page in (16, 32, 48):
        assert DB.kernel_shape_limits(heads, kv_heads, head_dim, page) == []
    assert LO.kernel_shape_limits(256, 8192) == [] and FA.kernel_shape_limits(80) == []


def test_limits_are_named():
    limits = DB.kernel_shape_limits(5, 2, 80, 24)
    assert len(limits) == 3
    assert "head_dim 80" in limits[0] and "64 or 128" in limits[0]
    assert "5 query heads over 2 kv heads" in limits[1]
    assert "page 24" in limits[2] and "multiples of 16" in limits[2]
    assert "LoRA rank 512" in LO.kernel_shape_limits(512, 1536)[0]
    assert "model width 9000" in LO.kernel_shape_limits(8, 9000)[0]


@pytest.mark.parametrize("build", ["paged", "batch", "make_engine"])
def test_engine_factories_refuse_head_dim_80_on_the_card(quantized, build, monkeypatch):
    """Before the device is even resolved: no card is needed to refuse."""
    cfg = _cfg()  # 160 / 2 heads: head_dim 80
    params = quantized(cfg)
    if build == "paged":
        call = lambda: tq.make_paged_engine(params, cfg)  # noqa: E731
    elif build == "batch":
        call = lambda: tq.make_batch_engine(params, cfg, device="cuda")  # noqa: E731
    else:
        from dora_tpu_torch.nodehub.llm_server import make_engine

        monkeypatch.setenv("DORA_PAGED_KV", "0")
        call = lambda: make_engine(params, cfg)  # noqa: E731
    with pytest.raises(ValueError, match="head_dim 80: the attention kernels take head_dim "
                                         "64 or 128"):
        call()
    # the CPU's plain versions serve it
    engine = (tq.make_paged_engine(params, cfg, device="cpu") if build == "paged"
              else tq.make_batch_engine(params, cfg, device="cpu"))
    assert engine.max_seq == cfg.max_seq


def test_paged_engine_refuses_a_page_of_8_on_the_card(quantized):
    """Page 8 (the JAX package's smallest) stays outside the 16-row sweep."""
    cfg = _cfg(dim=128)  # head_dim 64
    params = quantized(cfg)
    with pytest.raises(ValueError, match="make_paged_engine: page 8: .* multiples of 16"):
        tq.make_paged_engine(params, cfg, page_size=8, chunk=16)
    tq.make_paged_engine(params, cfg, page_size=8, chunk=16, device="cpu")


def test_lora_pool_refuses_rank_300_on_the_card(tmp_path):
    cfg = _cfg(dim=128)
    rng = np.random.default_rng(0)
    np.savez(tmp_path / "t0.npz", a_0=rng.standard_normal((128, 300)).astype(np.float32),
             b_0=rng.standard_normal((300, 128)).astype(np.float32))
    with pytest.raises(ValueError, match="make_lora_pool: LoRA rank 300: .* rank 1..256"):
        tq.make_lora_pool(cfg, str(tmp_path))
    with pytest.raises(ValueError, match="LoRA rank 300"):
        tq.make_lora_pool(cfg, str(tmp_path), rank=300, device="cuda")
    assert tq.make_lora_pool(cfg, str(tmp_path), device="cpu") is not None


def test_generate_refuses_unkernelled_shapes_on_the_card(quantized, monkeypatch):
    """qwen2.generate and the VLM's generation check the card's kernels
    before the prompt runs; ``on_card`` stands in for a card here."""
    cfg = _cfg()
    params = quantized(cfg)
    ids = torch.tensor([[1, 2, 3]])
    assert tq.generate(params, cfg, ids, 2).shape == (1, 2)  # CPU: plain versions
    monkeypatch.setattr(tvlm, "on_card", lambda device: True)
    with pytest.raises(ValueError, match="qwen2.generate: head_dim 80"):
        tq.generate(params, cfg, ids, 2)

    vcfg = tvlm.VLMConfig(image_size=16, patch_size=8, vision_dim=36, vision_layers=1,
                          vision_heads=3, vision_ffn=32, vocab=64, dim=160, layers=1,
                          heads=2, kv_heads=1, ffn=64, max_seq=32)
    vparams = tvlm.quantize_decode(tvlm.init_params(vcfg, seed=0, device="cpu"))
    images = torch.zeros((1, 16, 16, 3))
    monkeypatch.setenv("DORA_FLASH_ATTENTION", "1")
    for fn, args in ((tvlm.generate, (4,)), (tvlm.generate_speculative, (4,))):
        with pytest.raises(ValueError, match="head_dim 12: the flash_attention kernel .*; "
                                             "head_dim 80: the attention kernels"):
            fn(vparams, vcfg, images, ids, *args)
    monkeypatch.setenv("DORA_FLASH_ATTENTION", "0")
    with pytest.raises(ValueError, match="^vlm.generate: head_dim 80"):
        tvlm.generate(vparams, vcfg, images, ids, 4)
