"""The port's Qwen2-VL (dora_tpu_torch.models.hf.qwen2_vl) against dora_tpu's,
on the CPU.

The tiny checkpoint is built offline by ``transformers`` (the fixture of
tests/test_hf_parity.py: a 2-layer LM 64 wide, 4 / 2 heads of 16,
``mrope_section`` [2, 3, 3]; a 2-layer vision tower 32 wide, patch 4, merge
2), and both packages load the same directory. Tolerances:

* exact: ``from_hf``, ``map_params`` and ``load`` (bit for bit against
  ``params_from_jax`` of JAX's tree, both on-disk layouts), the quantized
  trees (int8 and int4), ``smart_resize``, ``rope_index``,
  ``vision_rotary``, ``_block_diag_mask``, ``build_prompt_ids``, and every
  token stream: ``generate`` (unquantized at batch 1 and 2, int8 and int4,
  fused and under ``DORA_FUSED_DECODE=0``, at 0 and 10 new tokens),
  ``generate_speculative`` tokens and passes, and ``make_serving_step`` on a
  uint8 frame. The prompts hold an image, so the M-RoPE position (delta)
  is below the cache position at decode;
* f32, within F32_TOL of the largest magnitude: ``_mrope_tables``,
  ``preprocess_image`` (shrinking, enlarging, same size), ``encode_images``
  (one image and two, the block-diagonal mask) and ``forward`` logits (with
  and without an image). Both packages compute in f32 on the CPU; the
  products sum in another order, and the resampling of an image differs by
  at most a few 1e-7 before its normalization.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dora_tpu.models.hf import qwen2_vl as jqv
from dora_tpu_torch.models import vlm as tvlm
from dora_tpu_torch.models.hf import qwen2 as tq
from dora_tpu_torch.models.hf import qwen2_vl as tqv

F32_TOL = 1e-5
MAX_SEQ = 128
KNOBS = ("DORA_FUSED_DECODE", "DORA_INT4_DECODE", "DORA_WEIGHT_BITS", "DORA_INT8_PURE",
         "DORA_SPEC_BODY", "DORA_SPEC_ADAPTIVE", "DORA_SPEC_WORST_CASE")


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    from transformers import Qwen2VLConfig, Qwen2VLForConditionalGeneration

    config = Qwen2VLConfig(
        vocab_size=300, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=256,
        rope_theta=10000.0, rms_norm_eps=1e-6, tie_word_embeddings=False,
        rope_scaling={"type": "mrope", "mrope_section": [2, 3, 3]},
        image_token_id=290, video_token_id=291, vision_start_token_id=292,
        vision_end_token_id=293,
        vision_config={"depth": 2, "embed_dim": 32, "num_heads": 2, "mlp_ratio": 2,
                       "patch_size": 4, "temporal_patch_size": 2, "spatial_merge_size": 2,
                       "in_channels": 3, "hidden_size": 64},
        attn_implementation="eager",
    )
    torch.manual_seed(9)
    model = Qwen2VLForConditionalGeneration(config).eval()
    path = tmp_path_factory.mktemp("qwen2vl-tiny-port")
    model.save_pretrained(path, safe_serialization=True)
    return path


@pytest.fixture(scope="module")
def loaded(checkpoint):
    jcfg, jparams = jqv.load(checkpoint, max_seq=MAX_SEQ)
    tcfg, tparams = tqv.load(checkpoint, max_seq=MAX_SEQ, device="cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture()
def knobs(monkeypatch):
    for knob in KNOBS:
        monkeypatch.delenv(knob, raising=False)
    return monkeypatch


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, tol=F32_TOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-30))


def _tree_equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for key in a:
            _tree_equal(a[key], b[key], f"{path}/{key}")
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype)
        assert torch.equal(a, b), path


def _fresh_jax():
    """The JAX bodies read DORA_FUSED_DECODE when they trace; drop their
    traces so a changed knob takes effect."""
    jqv._generate_jit.clear_cache()
    jqv._generate_spec_jit.clear_cache()


def _inputs(seed, grids=((1, 4, 4),), before=3, after=4, batch=1):
    """Prompt ids with a <|vision_start|><|image_pad|>*N run per image of
    ``grids`` (over the batch rows in order) and the images' patches."""
    rng = np.random.default_rng(seed)
    grid_thw = np.array(list(grids) * batch)
    patches = rng.normal(size=(int(grid_thw.prod(axis=1).sum()), 3 * 2 * 4 * 4))
    rows = []
    for _ in range(batch):
        ids = list(rng.integers(0, 280, size=before))
        for g in grids:
            ids += [292] + [290] * (int(np.prod(g)) // 4) + list(rng.integers(0, 280, size=after))
        rows.append(ids)
    return np.array(rows, dtype=np.int64), patches.astype(np.float32), grid_thw


# ---------------------------------------------------------------------------
# config, weights, host-side bookkeeping: exact
# ---------------------------------------------------------------------------


def test_from_hf_matches_jax(checkpoint):
    import json

    hf = json.loads((checkpoint / "config.json").read_text())
    for config in (hf, {**hf, "rope_scaling": None}):
        for max_seq in (None, 96):
            j = jqv.Qwen2VLConfig.from_hf(config, max_seq)
            t = tqv.Qwen2VLConfig.from_hf(config, max_seq)
            assert dataclasses.asdict(t) == dataclasses.asdict(j)
            assert (t.head_dim, t.vision.head_dim, t.vision.merge_dim) == (
                j.head_dim, j.vision.head_dim, j.vision.merge_dim)
    # without rope_scaling one section covers the half head
    assert tqv.Qwen2VLConfig.from_hf({**hf, "rope_scaling": None}).mrope_section == (8,)


def _equal_to_jax_tree(tparams, jparams):
    _tree_equal(tparams, tq.params_from_jax(jparams, device="cpu"))


def test_load_matches_params_from_jax(loaded):
    _, jparams, _, tparams = loaded
    assert set(tparams["vision"]) >= {"patch_proj", "blocks", "merger_fc2"}
    _equal_to_jax_tree(tparams, jparams)


def test_map_params_takes_both_layouts(checkpoint, loaded):
    """The nested layout (model.language_model.*, model.visual.*) maps to the
    same tree as the original one (model.* text, visual.* at the top) that
    transformers writes here."""
    from safetensors.numpy import load_file

    jcfg, jparams, tcfg, _ = loaded
    tensors = load_file(checkpoint / "model.safetensors")
    assert any(k.startswith("visual.") for k in tensors)

    def nested(k):
        if k.startswith("visual."):
            return "model." + k
        return k.replace("model.", "model.language_model.", 1)

    new = {nested(k): v for k, v in tensors.items()}
    got = tqv.map_params({k: torch.from_numpy(v) for k, v in new.items()}, tcfg)
    _equal_to_jax_tree(got, jqv.map_params(new, jcfg))
    _equal_to_jax_tree(got, jparams)


@pytest.mark.parametrize("bits", ["8", "4"])
def test_quantize_decode_matches_jax(loaded, knobs, bits):
    jcfg, jparams, tcfg, tparams = loaded
    if bits == "4":
        knobs.setenv("DORA_INT4_DECODE", "1")
    want = tq.params_from_jax(jqv.quantize_decode(jparams, jcfg), device="cpu")
    got = tqv.quantize_decode(tparams, tcfg)
    _tree_equal(got, want)
    assert ("int4" if bits == "4" else "int8") in got["blocks"]["0"]["wqkv"]
    assert tvlm.fused_decode_ready(got) and not tvlm.fused_decode_ready(tparams)


def test_smart_resize_and_build_prompt_ids_match_jax(loaded):
    jcfg, _, tcfg, _ = loaded
    for h, w in ((448, 448), (480, 640), (20, 30), (1080, 1920), (5000, 300), (28, 28)):
        assert tqv.smart_resize(h, w) == jqv.smart_resize(h, w)
        assert tqv.smart_resize(h, w, factor=8, min_pixels=64, max_pixels=4096) == \
            jqv.smart_resize(h, w, factor=8, min_pixels=64, max_pixels=4096)
    for th, tw in ((16, 16), (16, 24), (32, 8)):
        got = tqv.build_prompt_ids(tcfg, [5, 6, 7], th, tw)
        np.testing.assert_array_equal(got, jqv.build_prompt_ids(jcfg, [5, 6, 7], th, tw))
        assert got.dtype == np.int64


@pytest.mark.parametrize("grids,batch", [
    pytest.param((), 1, id="text"), pytest.param(((1, 4, 4),), 1, id="one-image"),
    pytest.param(((1, 4, 4), (1, 4, 6)), 1, id="two-images"),
    pytest.param(((1, 4, 4),), 2, id="batch-2")])
def test_rope_index_and_vision_tables_match_jax(loaded, grids, batch):
    jcfg, _, tcfg, _ = loaded
    ids, _, grid_thw = _inputs(3, grids or ((1, 4, 4),), batch=batch)
    if not grids:
        ids, grid_thw = ids[:, :5], None
    pos_t, delta_t = tqv.rope_index(tcfg, ids, grid_thw)
    pos_j, delta_j = jqv.rope_index(jcfg, ids, grid_thw)
    np.testing.assert_array_equal(pos_t, pos_j)
    np.testing.assert_array_equal(delta_t, delta_j)
    if grids:
        assert (delta_t < ids.shape[1]).all()  # the image's rows share positions
        np.testing.assert_array_equal(tqv.vision_rotary(tcfg.vision, grid_thw),
                                      jqv.vision_rotary(jcfg.vision, grid_thw))
        mt, mj = tqv._block_diag_mask(grid_thw), jqv._block_diag_mask(grid_thw)
        assert (mt is None) == (mj is None) == (len(grid_thw) == 1)
        if mt is not None:
            np.testing.assert_array_equal(mt, mj)


# ---------------------------------------------------------------------------
# f32 numerics
# ---------------------------------------------------------------------------


def test_mrope_tables_match_jax(loaded):
    jcfg, _, tcfg, _ = loaded
    ids, _, grid_thw = _inputs(4, ((1, 4, 4), (1, 4, 6)), batch=1)
    pos, _ = jqv.rope_index(jcfg, ids, grid_thw)
    jc, js = jqv._mrope_tables(jcfg, jnp.asarray(pos))
    tc, ts = tqv._mrope_tables(tcfg, torch.from_numpy(pos))
    assert tc.shape == (1, ids.shape[1], tcfg.head_dim // 2) and tc.dtype == torch.float32
    _close(tc, jc)
    _close(ts, js)


@pytest.mark.parametrize("size,dtype", [
    pytest.param((30, 44), "uint8", id="shrink-uint8"),
    pytest.param((10, 12), "float32", id="enlarge-float"),
    pytest.param((16, 24), "uint8", id="same-size")])
def test_preprocess_image_matches_jax(loaded, size, dtype):
    _, _, tcfg, _ = loaded
    rng = np.random.default_rng(5)
    if dtype == "uint8":
        image = rng.integers(0, 256, size=(*size, 3)).astype(np.uint8)
    else:
        image = rng.uniform(size=(*size, 3)).astype(np.float32)
    want = jqv.preprocess_image(jnp.asarray(image), tcfg.vision, 16, 24)
    got = tqv.preprocess_image(torch.from_numpy(image), tcfg.vision, 16, 24)
    assert got.dtype == torch.float32 and got.shape == (4 * 6, 3 * 2 * 4 * 4)
    _close(got, want)


@pytest.mark.parametrize("grids", [((1, 4, 4),), ((1, 4, 4), (1, 4, 6))],
                         ids=["one-image", "two-images"])
def test_encode_images_matches_jax(loaded, grids):
    jcfg, jparams, tcfg, tparams = loaded
    _, patches, grid_thw = _inputs(6, grids)
    want = jqv.encode_images(jparams, jcfg, patches, grid_thw)
    got = tqv.encode_images(tparams, tcfg, torch.from_numpy(patches), grid_thw)
    assert got.shape == (sum(int(np.prod(g)) for g in grids) // 4, tcfg.dim)
    _close(got, want)


@pytest.mark.parametrize("with_image", [True, False], ids=["image", "text"])
def test_forward_logits_match_jax(loaded, with_image):
    jcfg, jparams, tcfg, tparams = loaded
    ids, patches, grid_thw = _inputs(7, ((1, 4, 4), (1, 4, 6)))
    feats_j = feats_t = None
    if with_image:
        feats_j = jqv.encode_images(jparams, jcfg, patches, grid_thw)
        feats_t = tqv.encode_images(tparams, tcfg, patches, grid_thw)
    pos, _ = jqv.rope_index(jcfg, ids, grid_thw if with_image else None)
    want = jqv.forward(jparams, jcfg, jnp.asarray(ids, jnp.int32), feats_j, jnp.asarray(pos))
    got = tqv.forward(tparams, tcfg, torch.from_numpy(ids), feats_t, torch.from_numpy(pos))
    assert got.dtype == torch.float32 and got.shape == (1, ids.shape[1], tcfg.vocab)
    _close(got, want)


# ---------------------------------------------------------------------------
# tokens: exact
# ---------------------------------------------------------------------------


def _params(loaded, knobs, quant):
    """(jax params, port params) unquantized, int8 or int4; the port's from
    its own quantize_decode (equal to JAX's, test above)."""
    jcfg, jparams, tcfg, tparams = loaded
    if quant == "none":
        return jparams, tparams
    if quant == "int4":
        knobs.setenv("DORA_INT4_DECODE", "1")
    out = jqv.quantize_decode(jparams, jcfg), tqv.quantize_decode(tparams, tcfg)
    knobs.delenv("DORA_INT4_DECODE", raising=False)
    return out


QUANT_CASES = [("none", True, 1), ("none", True, 2), ("int8", True, 1), ("int8", False, 1),
               ("int4", True, 1), ("int4", False, 1)]


@pytest.mark.parametrize("quant,fused,batch,max_new", [
    pytest.param(q, f, b, n, id=f"{q}-{'fused' if f else 'unfused'}-b{b}-{n}")
    for q, f, b in QUANT_CASES for n in (10, 0)])
def test_generate_matches_jax(loaded, knobs, quant, fused, batch, max_new):
    jcfg, _, tcfg, _ = loaded
    jp, tp = _params(loaded, knobs, quant)
    if not fused:
        knobs.setenv("DORA_FUSED_DECODE", "0")
    _fresh_jax()
    assert tvlm.fused_decode_ready(tp, batch) == (quant != "none" and fused and batch == 1)
    ids, patches, grid_thw = _inputs(20 + batch, batch=batch)
    want = np.asarray(jqv.generate(jp, jcfg, ids, patches, grid_thw, max_new))
    got = tqv.generate(tp, tcfg, torch.from_numpy(ids), torch.from_numpy(patches), grid_thw,
                       max_new)
    assert got.dtype == torch.int32 and got.shape == want.shape == (batch, max_new)
    np.testing.assert_array_equal(_np(got), want)


def test_generate_text_only_matches_jax(loaded, knobs):
    jcfg, _, tcfg, _ = loaded
    jp, tp = _params(loaded, knobs, "int8")
    _fresh_jax()
    ids = np.random.default_rng(8).integers(0, 280, size=(1, 9))
    want = np.asarray(jqv.generate(jp, jcfg, ids, None, None, 10))
    np.testing.assert_array_equal(_np(tqv.generate(tp, tcfg, ids, None, None, 10)), want)


@pytest.mark.parametrize("quant,fused,max_new", [
    pytest.param(q, f, n, id=f"{q}-{'fused' if f else 'unfused'}-{n}")
    for q, f, _ in QUANT_CASES if _ == 1 for n in (10, 0)])
def test_generate_speculative_matches_jax(loaded, knobs, quant, fused, max_new):
    """Tokens and model passes equal the JAX package's, and the tokens equal
    ``generate``'s. The prompt repeats its text so drafts get accepted."""
    jcfg, _, tcfg, _ = loaded
    jp, tp = _params(loaded, knobs, quant)
    if not fused:
        knobs.setenv("DORA_FUSED_DECODE", "0")
    _fresh_jax()
    ids, patches, grid_thw = _inputs(30, before=6, after=6)
    ids = np.concatenate([ids, ids[:, :6]], axis=1)
    want, want_passes = jqv.generate_speculative(jp, jcfg, ids, patches, grid_thw, max_new)
    got, passes = tqv.generate_speculative(tp, tcfg, ids, torch.from_numpy(patches), grid_thw,
                                           max_new)
    assert got.dtype == torch.int32 and got.shape == (1, max_new)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    assert passes == int(want_passes)
    np.testing.assert_array_equal(
        _np(got), _np(tqv.generate(tp, tcfg, ids, patches, grid_thw, max_new)))


@pytest.mark.parametrize("speculative", [False, True], ids=["greedy", "speculative"])
@pytest.mark.parametrize("quant", ["none", "int8"])
def test_serving_step_matches_jax(loaded, knobs, quant, speculative):
    """make_serving_step on a uint8 frame that is resized to the step's
    geometry (16 x 24: 6 merged image tokens)."""
    jcfg, _, tcfg, _ = loaded
    jp, tp = _params(loaded, knobs, quant)
    _fresh_jax()
    prompt = tqv.build_prompt_ids(tcfg, [11, 12, 13, 14], 16, 24)
    image = np.random.default_rng(9).integers(0, 256, size=(20, 28, 3)).astype(np.uint8)
    want = jqv.make_serving_step(jcfg, prompt, 16, 24, 10, speculative)(jp, jnp.asarray(image))
    got = tqv.make_serving_step(tcfg, prompt, 16, 24, 10, speculative)(
        tp, torch.from_numpy(image))
    assert got.dtype == torch.int32 and got.shape == (1, 10)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_max_seq_guards(loaded):
    _, _, tcfg, tparams = loaded
    ids, patches, grid_thw = _inputs(10, before=60, after=40)
    assert ids.shape[1] == 105
    with pytest.raises(ValueError, match="exceeds max_seq"):
        tqv.generate(tparams, tcfg, ids, patches, grid_thw, 24)
    with pytest.raises(ValueError, match="speculation headroom"):
        tqv.generate_speculative(tparams, tcfg, ids, patches, grid_thw, 20)
    with pytest.raises(ValueError, match="batch-1"):
        tqv.generate_speculative(tparams, tcfg, np.concatenate([ids, ids]), patches, grid_thw, 4)
    with pytest.raises(ValueError, match="exceeds max_seq"):
        tqv.make_serving_step(tcfg, ids, 16, 16, 20, speculative=True)
    assert tqv.generate(tparams, tcfg, ids, patches, grid_thw, 23).shape == (1, 23)


def test_card_refuses_the_tiny_head_dim(loaded, knobs):
    """On the card the fused tier's kernels take head_dim 64 or 128: the
    fixture's 16 is refused, by name, before the tower runs (``on_card``
    stands in for a card); the CPU's plain versions serve it."""
    _, tp = _params(loaded, knobs, "int8")
    tcfg = loaded[2]
    ids, patches, grid_thw = _inputs(11)
    knobs.setattr(tvlm, "on_card", lambda device: True)
    with pytest.raises(ValueError, match="^qwen2_vl.generate: head_dim 16"):
        tqv.generate(tp, tcfg, ids, patches, grid_thw, 4)
    with pytest.raises(ValueError, match="^qwen2_vl.generate_speculative: head_dim 16"):
        tqv.generate_speculative(tp, tcfg, ids, patches, grid_thw, 4)
    step = tqv.make_serving_step(tcfg, tqv.build_prompt_ids(tcfg, [1], 16, 16), 16, 16, 4)
    with pytest.raises(ValueError, match="^qwen2_vl.make_serving_step: head_dim 16"):
        step(tp, torch.zeros((16, 16, 3), dtype=torch.uint8))
