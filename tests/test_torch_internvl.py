"""The port's InternVL (dora_tpu_torch.models.hf.internvl) against dora_tpu's,
on the CPU.

The tiny checkpoint is built offline by ``transformers`` (the fixture of
tests/test_hf_parity.py: an InternViT of 2 layers 32 wide with q/k norm
and biases, 16-pixel tiles of 4-pixel patches, 4 tokens a tile after the
pixel shuffle; a Qwen2 LM of 2 layers 64 wide, 4 / 2 heads of 16), and both
packages load the same directory. Tolerances:

* exact: ``from_hf``, ``map_params`` and ``load`` (bit for bit against
  ``params_from_jax`` of JAX's tree, both on-disk layouts), the quantized
  trees (int8 and int4), ``target_ratios``, ``closest_aspect_ratio``,
  ``tile_grid``, ``build_prompt_ids``, and every token stream:
  ``generate`` (unquantized at batch 1 and 2, int8 and int4, fused and
  under ``DORA_FUSED_DECODE=0``, at 0 and 10 new tokens),
  ``generate_speculative`` tokens and passes, and ``make_serving_step`` on a
  uint8 frame;
* f32, within F32_TOL of the largest magnitude: ``preprocess_tiles``
  (shrinking, enlarging, one tile), the pixel shuffle, ``encode_images``
  (one tile and three) and ``forward`` logits (with and without tiles).
  Both packages compute in f32 on the CPU; products sum in another order,
  and the bicubic resampling differs by at most a few 1e-7 before its
  normalization.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dora_tpu.models.hf import internvl as jiv
from dora_tpu_torch.models import vlm as tvlm
from dora_tpu_torch.models.hf import internvl as tiv
from dora_tpu_torch.models.hf import qwen2 as tq

F32_TOL = 1e-5
MAX_SEQ = 128
KNOBS = ("DORA_FUSED_DECODE", "DORA_INT4_DECODE", "DORA_WEIGHT_BITS", "DORA_INT8_PURE",
         "DORA_SPEC_BODY", "DORA_SPEC_ADAPTIVE", "DORA_SPEC_WORST_CASE")


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    from transformers import InternVLConfig, InternVLForConditionalGeneration

    config = InternVLConfig(
        vision_config=dict(
            hidden_size=32, num_hidden_layers=2, num_attention_heads=2, intermediate_size=64,
            image_size=[16, 16], patch_size=[4, 4], use_qk_norm=True,
            layer_scale_init_value=0.1, norm_type="layer_norm",
            use_absolute_position_embeddings=True, use_mean_pooling=True, attention_bias=True,
        ),
        text_config=dict(
            model_type="qwen2", vocab_size=300, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=256, rope_theta=10000.0, tie_word_embeddings=False,
        ),
        image_token_id=290, downsample_ratio=0.5, projector_hidden_act="gelu",
        attn_implementation="eager",
    )
    torch.manual_seed(23)
    model = InternVLForConditionalGeneration(config).eval()
    path = tmp_path_factory.mktemp("internvl-tiny-port")
    model.save_pretrained(path, safe_serialization=True)
    return path


@pytest.fixture(scope="module")
def loaded(checkpoint):
    jcfg, jparams = jiv.load(checkpoint, max_seq=MAX_SEQ)
    tcfg, tparams = tiv.load(checkpoint, max_seq=MAX_SEQ, device="cpu")
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
    jiv._generate_jit.clear_cache()
    jiv._generate_spec_jit.clear_cache()


def _inputs(cfg, seed, n_tiles=2, text_len=4, batch=1):
    """<IMG_CONTEXT> runs for ``n_tiles`` tiles + trailing text ids, per row."""
    rng = np.random.default_rng(seed)
    tiles = rng.normal(size=(n_tiles * batch, 3, 16, 16)).astype(np.float32)
    rows = [[cfg.image_token_id] * (cfg.tokens_per_tile * n_tiles)
            + list(rng.integers(0, 280, size=text_len)) for _ in range(batch)]
    return np.array(rows, dtype=np.int64), tiles


# ---------------------------------------------------------------------------
# config, weights, tiling: exact
# ---------------------------------------------------------------------------


def test_from_hf_matches_jax(checkpoint):
    import json

    hf = json.loads((checkpoint / "config.json").read_text())
    for config in (hf, {**hf, "vision_config": {**hf["vision_config"], "image_size": 16,
                                                "patch_size": 4}}):
        for max_seq in (None, 96):
            j = jiv.InternVLConfig.from_hf(config, max_seq)
            t = tiv.InternVLConfig.from_hf(config, max_seq)
            assert dataclasses.asdict(t) == dataclasses.asdict(j)
            assert t.tokens_per_tile == j.tokens_per_tile == 4
            assert (t.vision.head_dim, t.vision.n_patches) == (j.vision.head_dim,
                                                              j.vision.n_patches)


def test_load_matches_params_from_jax(loaded):
    _, jparams, _, tparams = loaded
    blk = tparams["vision"]["blocks"]["0"]
    assert {"q_norm", "k_norm", "bq", "bk", "bv", "lambda1"} <= set(blk)
    _tree_equal(tparams, tq.params_from_jax(jparams, device="cpu"))


def test_map_params_takes_both_layouts(checkpoint, loaded):
    """The nested layout (model.language_model.*, model.vision_tower.*,
    lm_head.weight) maps to the same tree as the legacy export
    (language_model.model.*, vision_tower.*, language_model.lm_head.weight)
    that transformers writes here; without q/k norm the tower has no norm
    weights."""
    from safetensors.numpy import load_file

    jcfg, jparams, tcfg, _ = loaded
    tensors = load_file(checkpoint / "model.safetensors")
    assert "language_model.lm_head.weight" in tensors

    def nested(k):
        if k == "language_model.lm_head.weight":
            return "lm_head.weight"
        return (k.replace("language_model.model.", "model.language_model.")
                .replace("vision_tower.", "model.vision_tower.")
                .replace("multi_modal_projector.", "model.multi_modal_projector."))

    new = {nested(k): v for k, v in tensors.items()}
    got = tiv.map_params({k: torch.from_numpy(v) for k, v in new.items()}, tcfg)
    _tree_equal(got, tq.params_from_jax(jiv.map_params(new, jcfg), device="cpu"))
    _tree_equal(got, tq.params_from_jax(jparams, device="cpu"))
    no_norm = dataclasses.replace(tcfg, vision=dataclasses.replace(tcfg.vision,
                                                                   use_qk_norm=False))
    blk = tiv.map_params({k: torch.from_numpy(v) for k, v in tensors.items()},
                         no_norm)["vision"]["blocks"]["1"]
    assert "q_norm" not in blk and "bq" in blk


@pytest.mark.parametrize("bits", ["8", "4"])
def test_quantize_decode_matches_jax(loaded, knobs, bits):
    jcfg, jparams, tcfg, tparams = loaded
    if bits == "4":
        knobs.setenv("DORA_INT4_DECODE", "1")
    want = tq.params_from_jax(jiv.quantize_decode(jparams, jcfg), device="cpu")
    got = tiv.quantize_decode(tparams, tcfg)
    _tree_equal(got, want)
    assert ("int4" if bits == "4" else "int8") in got["blocks"]["0"]["wqkv"]
    assert tvlm.fused_decode_ready(got) and not tvlm.fused_decode_ready(tparams)


def test_tiling_matches_jax(loaded):
    jcfg, _, tcfg, _ = loaded
    for lo, hi in ((1, 12), (1, 6), (2, 9)):
        assert tiv.target_ratios(lo, hi) == jiv.target_ratios(lo, hi)
    sizes = ((896, 448), (448, 448), (1280, 720), (448, 896), (100, 1000), (3000, 40),
             (180, 90), (32, 16), (640, 480))
    for w, h in sizes:
        for tile in (448, 32, 16):
            assert tiv.tile_grid(w, h, tile=tile) == jiv.tile_grid(w, h, tile=tile)
            assert tiv.tile_grid(w, h, tile=tile, max_num=6, use_thumbnail=False) == \
                jiv.tile_grid(w, h, tile=tile, max_num=6, use_thumbnail=False)
            assert tiv.closest_aspect_ratio(w, h, tiv.target_ratios(), tile) == \
                jiv.closest_aspect_ratio(w, h, jiv.target_ratios(), tile)
    assert tiv.tile_grid(896, 448) == (2, 1, 3)
    for n, start, end in ((1, None, None), (3, 288, 289)):
        got = tiv.build_prompt_ids(tcfg, [5, 6], n, start, end)
        np.testing.assert_array_equal(got, jiv.build_prompt_ids(jcfg, [5, 6], n, start, end))
        assert got.dtype == np.int64


# ---------------------------------------------------------------------------
# f32 numerics
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size,grid,dtype", [
    pytest.param((20, 44), (2, 1), "uint8", id="shrink-uint8"),
    pytest.param((12, 10), (1, 1), "float32", id="enlarge-float"),
    pytest.param((16, 16), (1, 1), "uint8", id="one-tile-same-size"),
    pytest.param((40, 18), (1, 3), "float32", id="portrait")])
def test_preprocess_tiles_matches_jax(size, grid, dtype):
    rng = np.random.default_rng(5)
    if dtype == "uint8":
        image = rng.integers(0, 256, size=(*size, 3)).astype(np.uint8)
    else:  # past [0, 1] too: the clamp comes after the resize
        image = rng.uniform(-0.1, 1.1, size=(*size, 3)).astype(np.float32)
    cols, rows = grid
    want = jiv.preprocess_tiles(jnp.asarray(image), cols, rows, tile=16)
    got = tiv.preprocess_tiles(torch.from_numpy(image), cols, rows, tile=16)
    n = cols * rows + (cols * rows != 1)
    assert got.dtype == torch.float32 and got.shape == (n, 3, 16, 16)
    _close(got, want)


def test_pixel_shuffle_and_patchify_match_jax():
    x = np.arange(2 * 4 * 4 * 8, dtype=np.float32).reshape(2, 4, 4, 8)
    np.testing.assert_array_equal(_np(tiv._pixel_shuffle(torch.from_numpy(x), 0.5)),
                                  np.asarray(jiv._pixel_shuffle(jnp.asarray(x), 0.5)))
    y = np.arange(2 * 3 * 8 * 8, dtype=np.float32).reshape(2, 3, 8, 8)
    np.testing.assert_array_equal(_np(tiv._patchify(torch.from_numpy(y), 4)),
                                  np.asarray(jiv._patchify(jnp.asarray(y), 4)))


@pytest.mark.parametrize("n_tiles", [1, 3])
def test_encode_images_matches_jax(loaded, n_tiles):
    jcfg, jparams, tcfg, tparams = loaded
    _, tiles = _inputs(tcfg, 6, n_tiles=n_tiles)
    want = jiv.encode_images(jparams, jcfg, tiles)
    got = tiv.encode_images(tparams, tcfg, torch.from_numpy(tiles))
    assert got.shape == (n_tiles * tcfg.tokens_per_tile, tcfg.text.dim)
    _close(got, want)


@pytest.mark.parametrize("with_image", [True, False], ids=["image", "text"])
def test_forward_logits_match_jax(loaded, with_image):
    jcfg, jparams, tcfg, tparams = loaded
    ids, tiles = _inputs(tcfg, 7)
    feats_j = feats_t = None
    if with_image:
        feats_j = jiv.encode_images(jparams, jcfg, tiles)
        feats_t = tiv.encode_images(tparams, tcfg, tiles)
    want = jiv.forward(jparams, jcfg, jnp.asarray(ids, jnp.int32), feats_j)
    got = tiv.forward(tparams, tcfg, torch.from_numpy(ids), feats_t)
    assert got.dtype == torch.float32 and got.shape == (1, ids.shape[1], tcfg.text.vocab)
    _close(got, want)


# ---------------------------------------------------------------------------
# tokens: exact
# ---------------------------------------------------------------------------


def _params(loaded, knobs, quant):
    jcfg, jparams, tcfg, tparams = loaded
    if quant == "none":
        return jparams, tparams
    if quant == "int4":
        knobs.setenv("DORA_INT4_DECODE", "1")
    out = jiv.quantize_decode(jparams, jcfg), tiv.quantize_decode(tparams, tcfg)
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
    ids, tiles = _inputs(tcfg, 20 + batch, batch=batch)
    want = np.asarray(jiv.generate(jp, jcfg, ids, tiles, max_new))
    got = tiv.generate(tp, tcfg, torch.from_numpy(ids), torch.from_numpy(tiles), max_new)
    assert got.dtype == torch.int32 and got.shape == want.shape == (batch, max_new)
    np.testing.assert_array_equal(_np(got), want)


def test_generate_text_only_matches_jax(loaded, knobs):
    jcfg, _, tcfg, _ = loaded
    jp, tp = _params(loaded, knobs, "int8")
    _fresh_jax()
    ids = np.random.default_rng(8).integers(0, 280, size=(1, 7))
    want = np.asarray(jiv.generate(jp, jcfg, ids, None, 10))
    np.testing.assert_array_equal(_np(tiv.generate(tp, tcfg, ids, None, 10)), want)


@pytest.mark.parametrize("quant,fused,max_new", [
    pytest.param(q, f, n, id=f"{q}-{'fused' if f else 'unfused'}-{n}")
    for q, f, b in QUANT_CASES if b == 1 for n in (10, 0)])
def test_generate_speculative_matches_jax(loaded, knobs, quant, fused, max_new):
    """Tokens and model passes equal the JAX package's, and the tokens equal
    ``generate``'s. The prompt repeats its text so drafts get accepted."""
    jcfg, _, tcfg, _ = loaded
    jp, tp = _params(loaded, knobs, quant)
    if not fused:
        knobs.setenv("DORA_FUSED_DECODE", "0")
    _fresh_jax()
    ids, tiles = _inputs(tcfg, 30, text_len=6)
    ids = np.concatenate([ids, ids[:, -6:]], axis=1)
    want, want_passes = jiv.generate_speculative(jp, jcfg, ids, tiles, max_new)
    got, passes = tiv.generate_speculative(tp, tcfg, ids, torch.from_numpy(tiles), max_new)
    assert got.dtype == torch.int32 and got.shape == (1, max_new)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    assert passes == int(want_passes)
    np.testing.assert_array_equal(_np(got), _np(tiv.generate(tp, tcfg, ids, tiles, max_new)))


@pytest.mark.parametrize("speculative", [False, True], ids=["greedy", "speculative"])
@pytest.mark.parametrize("quant", ["none", "int8"])
def test_serving_step_matches_jax(loaded, knobs, quant, speculative):
    """make_serving_step on a uint8 frame 16 high and 32 wide: a 2 x 1 grid
    of 16-pixel tiles and the thumbnail."""
    jcfg, _, tcfg, _ = loaded
    jp, tp = _params(loaded, knobs, quant)
    _fresh_jax()
    image = np.random.default_rng(9).integers(0, 256, size=(16, 32, 3)).astype(np.uint8)
    cols, rows, n_tiles = tiv.tile_grid(32, 16, tile=16)
    assert (cols, rows, n_tiles) == (2, 1, 3)
    prompt = tiv.build_prompt_ids(tcfg, [11, 12, 13, 14], n_tiles, 288, 289)
    want = jiv.make_serving_step(jcfg, prompt, cols, rows, 16, 10, speculative)(
        jp, jnp.asarray(image))
    got = tiv.make_serving_step(tcfg, prompt, cols, rows, 16, 10, speculative)(
        tp, torch.from_numpy(image))
    assert got.dtype == torch.int32 and got.shape == (1, 10)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_max_seq_guards(loaded):
    _, _, tcfg, tparams = loaded
    ids, tiles = _inputs(tcfg, 10, n_tiles=25, text_len=5)
    assert ids.shape[1] == 105
    with pytest.raises(ValueError, match="exceeds max_seq"):
        tiv.generate(tparams, tcfg, ids, tiles, 24)
    with pytest.raises(ValueError, match="speculation headroom"):
        tiv.generate_speculative(tparams, tcfg, ids, tiles, 20)
    with pytest.raises(ValueError, match="batch-1"):
        tiv.generate_speculative(tparams, tcfg, np.concatenate([ids, ids]), tiles, 4)
    with pytest.raises(ValueError, match="exceeds max_seq"):
        tiv.make_serving_step(tcfg, ids, 1, 1, 16, 20, speculative=True)
    assert tiv.generate(tparams, tcfg, ids, tiles, 23).shape == (1, 23)


def test_card_refuses_the_tiny_head_dim(loaded, knobs):
    """On the card the fused tier's kernels take head_dim 64 or 128: the
    fixture's 16 is refused, by name, before the tower runs (``on_card``
    stands in for a card); the CPU's plain versions serve it."""
    _, tp = _params(loaded, knobs, "int8")
    tcfg = loaded[2]
    ids, tiles = _inputs(tcfg, 11)
    knobs.setattr(tvlm, "on_card", lambda device: True)
    with pytest.raises(ValueError, match="^internvl.generate: head_dim 16"):
        tiv.generate(tp, tcfg, ids, tiles, 4)
    with pytest.raises(ValueError, match="^internvl.generate_speculative: head_dim 16"):
        tiv.generate_speculative(tp, tcfg, ids, tiles, 4)
    step = tiv.make_serving_step(tcfg, tiv.build_prompt_ids(tcfg, [1], 1), 1, 1, 16, 4)
    with pytest.raises(ValueError, match="^internvl.make_serving_step: head_dim 16"):
        step(tp, torch.zeros((16, 16, 3), dtype=torch.uint8))
