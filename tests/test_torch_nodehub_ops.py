"""The port's operator factories against dora_tpu's, on the CPU.

``make_vlm``, ``make_asr`` and ``make_vad`` are built in both packages from
the same environment, and one step (two for the VAD, whose GRU state
threads from tick to tick) runs on the same seeded input:

* the self-contained models (``DORA_MODEL_SIZE`` tiny) seed from each
  package's own generator, so the JAX operator's ``init_state`` is carried
  into the port's operator by ``params_from_jax`` (for the VLM after
  ``DORA_INT8_DECODE``'s quantization, as the JAX factory builds it);
* the HF branches load the same tiny ``transformers`` checkpoints
  (Whisper, Wav2Vec2, Qwen2-VL) through ``DORA_HF_CHECKPOINT``.

Tokens are exact; probabilities within 1e-5 of the largest value (f32
products summed in another order). Each output's dtype and shape are the
JAX operator's.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dora_tpu.nodehub import ops as jops
from dora_tpu_torch.models.hf.qwen2 import params_from_jax
from dora_tpu_torch.nodehub import ops as tops

transformers = pytest.importorskip("transformers")

KNOBS = ("DORA_MODEL_SIZE", "DORA_HF_CHECKPOINT", "DORA_INT8_DECODE", "DORA_INT4_DECODE",
         "DORA_SPEC_DECODE", "DORA_MAX_NEW_TOKENS", "DORA_PARAM_DTYPE", "DORA_CHECKPOINT",
         "DORA_MESH", "DORA_PROMPT", "DORA_FUSED_DECODE", "IMAGE_HEIGHT", "IMAGE_WIDTH")


@pytest.fixture()
def env(monkeypatch):
    for knob in KNOBS:
        monkeypatch.delenv(knob, raising=False)
    return monkeypatch


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _step_both(jop, top, inputs: dict | list, carry: bool):
    """Run both operators over the same inputs (a dict: one tick; a list:
    one tick each); returns the (JAX, port) outputs of each tick."""
    jstate = jop.init_state
    tstate = params_from_jax(jstate, device="cpu") if carry else top.init_state
    out = []
    for inputs in [inputs] if isinstance(inputs, dict) else inputs:
        jstate, jout = jop.step(jstate, {k: jnp.asarray(v) for k, v in inputs.items()})
        tstate, tout = top.step(tstate, {k: torch.from_numpy(v) for k, v in inputs.items()})
        out.append(({k: np.asarray(v) for k, v in jout.items()},
                    {k: _np(v) for k, v in tout.items()}))
    return out


def _equal(pairs, tol=None):
    for jout, tout in pairs:
        assert set(jout) == set(tout)
        for key, want in jout.items():
            got = tout[key]
            assert got.dtype == want.dtype and got.shape == want.shape, key
            if tol is None:
                np.testing.assert_array_equal(got, want, err_msg=key)
            else:
                np.testing.assert_allclose(got, want, rtol=0,
                                           atol=tol * max(np.abs(want).max(), 1e-30))


def _frame(seed, h=32, w=32):
    return np.random.default_rng(seed).integers(0, 256, size=(h, w, 3)).astype(np.uint8)


def _audio(seed, n):
    return (np.random.default_rng(seed).normal(size=n) * 0.2).astype(np.float32)


@pytest.mark.parametrize("knob", [None, "DORA_INT8_DECODE", "DORA_SPEC_DECODE"])
def test_make_vlm_tiny_matches(env, knob):
    if knob:
        env.setenv(knob, "1")
    env.setenv("DORA_MAX_NEW_TOKENS", "12")
    jop, top = jops.make_vlm(), tops.make_vlm(device="cpu")
    pairs = _step_both(jop, top, {"image": _frame(1)}, carry=True)
    _equal(pairs)
    assert pairs[0][1]["tokens"].shape == (12,)


def test_make_asr_tiny_matches(env):
    env.setenv("DORA_MAX_NEW_TOKENS", "10")
    _equal(_step_both(jops.make_asr(), tops.make_asr(device="cpu"), {"audio": _audio(2, 6000)},
                      carry=True))


def test_make_vad_tiny_threads_state(env):
    jop, top = jops.make_vad(), tops.make_vad(device="cpu")
    assert isinstance(top.init_state, tuple)
    chunk = _audio(3, 256)  # two frames: the carried state still shows
    pairs = _step_both(jop, top, [{"audio": chunk}, {"audio": chunk * 8}, {"audio": chunk}],
                       carry=True)
    _equal(pairs, tol=1e-5)
    # the same chunk after another one: the GRU state threaded through
    assert pairs[0][1]["prob"] != pairs[2][1]["prob"]


@pytest.fixture(scope="module")
def whisper_dir(tmp_path_factory):
    from transformers import WhisperConfig, WhisperForConditionalGeneration

    config = WhisperConfig(
        vocab_size=200, num_mel_bins=32, d_model=64, encoder_layers=2, decoder_layers=2,
        encoder_attention_heads=4, decoder_attention_heads=4, encoder_ffn_dim=128,
        decoder_ffn_dim=128, max_source_positions=50, max_target_positions=32,
        decoder_start_token_id=3, eos_token_id=2, bos_token_id=1, pad_token_id=0,
        suppress_tokens=[], begin_suppress_tokens=[], attn_implementation="eager",
    )
    torch.manual_seed(4)
    path = tmp_path_factory.mktemp("whisper-ops")
    WhisperForConditionalGeneration(config).eval().save_pretrained(path, safe_serialization=True)
    return path


@pytest.mark.parametrize("spec", [False, True])
def test_make_asr_whisper_matches(env, whisper_dir, spec):
    env.setenv("DORA_HF_CHECKPOINT", str(whisper_dir))
    env.setenv("DORA_MAX_NEW_TOKENS", "12")
    if spec:
        env.setenv("DORA_SPEC_DECODE", "1")
    pairs = _step_both(jops.make_asr(), tops.make_asr(device="cpu"),
                       {"audio": _audio(5, 12000)}, carry=False)
    _equal(pairs)
    assert pairs[0][1]["tokens"].shape == (12,)


def test_make_vad_wav2vec2_matches(env, tmp_path):
    from transformers import Wav2Vec2Config, Wav2Vec2ForAudioFrameClassification

    config = Wav2Vec2Config(
        vocab_size=32, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=64, conv_dim=[16, 16, 32], conv_stride=[5, 2, 2],
        conv_kernel=[10, 3, 3], num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
        num_labels=2, do_stable_layer_norm=False, feat_extract_norm="group",
    )
    torch.manual_seed(11)
    Wav2Vec2ForAudioFrameClassification(config).eval().save_pretrained(
        tmp_path, safe_serialization=True)
    env.setenv("DORA_HF_CHECKPOINT", str(tmp_path))
    pairs = _step_both(jops.make_vad(), tops.make_vad(device="cpu"),
                       {"audio": _audio(9, 3200)}, carry=False)
    _equal(pairs, tol=1e-5)
    assert pairs[0][1]["prob"].shape == (1,)


def test_make_vlm_qwen2_vl_matches(env, tmp_path):
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
    Qwen2VLForConditionalGeneration(config).eval().save_pretrained(
        tmp_path, safe_serialization=True)
    env.setenv("DORA_HF_CHECKPOINT", str(tmp_path))
    env.setenv("DORA_MAX_NEW_TOKENS", "6")
    env.setenv("DORA_MAX_SEQ", "160")
    env.setenv("IMAGE_HEIGHT", "56")
    env.setenv("IMAGE_WIDTH", "56")
    env.setenv("DORA_INT8_DECODE", "1")
    pairs = _step_both(jops.make_vlm(), tops.make_vlm(device="cpu"),
                       {"image": _frame(7, 56, 56)}, carry=False)
    _equal(pairs)
