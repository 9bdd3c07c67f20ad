"""The port's operator factories against dora_tpu's, on the CPU.

``make_vlm``, ``make_asr``, ``make_vad``, ``make_detector``,
``make_translator`` and ``make_tts`` are built in both packages from the
same environment, and one step (two for the VAD, whose GRU state threads
from tick to tick) runs on the same seeded input:

* the self-contained models (``DORA_MODEL_SIZE`` tiny) seed from each
  package's own generator, so the JAX operator's ``init_state`` is carried
  into the port's operator by ``params_from_jax`` (for the VLM after
  ``DORA_INT8_DECODE``'s quantization, as the JAX factory builds it; the
  detector's and the TTS's relay their convolutions);
* the HF branches load the same tiny ``transformers`` checkpoints
  (Whisper, Wav2Vec2, Qwen2-VL, YOLOS, VITS) through ``DORA_HF_CHECKPOINT``.

Tokens and classes are exact; probabilities, boxes, scores and waveforms
within 1e-5 (1e-4 for the detectors' boxes and scores and the waveforms:
convolutions) of the largest value (f32 products summed in another order).
Each output's dtype and shape are the JAX operator's.
"""

from __future__ import annotations

import jax
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
         "DORA_MESH", "DORA_PROMPT", "DORA_FUSED_DECODE", "IMAGE_HEIGHT", "IMAGE_WIDTH",
         "DORA_DETECT_THRESHOLD", "DORA_DETECT_TOPK", "DORA_TTS_STYLE")


@pytest.fixture()
def env(monkeypatch):
    for knob in KNOBS:
        monkeypatch.delenv(knob, raising=False)
    return monkeypatch


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _step_both(jop, top, inputs: dict | list, carry, jit: bool = False):
    """Run both operators over the same inputs (a dict: one tick; a list:
    one tick each); returns the (JAX, port) outputs of each tick. ``carry``
    (True, or the model's own ``params_from_jax``) carries the JAX
    operator's state into the port's; ``jit`` runs the JAX step compiled,
    as the JAX runtime does (op by op, every primitive compiles alone)."""
    jstate = jop.init_state
    jstep = jax.jit(jop.step) if jit else jop.step
    if carry:
        convert = params_from_jax if carry is True else carry
        tstate = convert(jax.device_get(jstate), device="cpu")
    else:
        tstate = top.init_state
    out = []
    for inputs in [inputs] if isinstance(inputs, dict) else inputs:
        jstate, jout = jstep(jstate, {k: jnp.asarray(v) for k, v in inputs.items()})
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


@pytest.mark.parametrize("size", ["tiny", "hf"])
def test_make_detector_matches(env, size, tmp_path):
    from dora_tpu_torch.models import detection

    if size == "hf":
        from transformers import YolosConfig, YolosForObjectDetection

        config = YolosConfig(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
                             intermediate_size=64, image_size=[32, 48], patch_size=8,
                             num_detection_tokens=5, num_labels=7, qkv_bias=True,
                             attn_implementation="eager")
        torch.manual_seed(17)
        YolosForObjectDetection(config).eval().save_pretrained(tmp_path,
                                                               safe_serialization=True)
        env.setenv("DORA_HF_CHECKPOINT", str(tmp_path))
        env.setenv("DORA_DETECT_THRESHOLD", "0.0")
        env.setenv("DORA_DETECT_TOPK", "4")
        image, carry, rows = _frame(20, 32, 48), False, 4
    else:
        from dora_tpu.models import detection as jdetection

        # init_params' shapes with seeded numpy values: its jax.random draws
        # compile one by one (18 s); the port's operator gets them carried over
        init = jdetection.init_params
        rng = np.random.default_rng(21)
        env.setattr(jdetection, "init_params", lambda key, cfg: jax.tree.map(
            lambda s: rng.uniform(-0.5, 0.5, s.shape).astype(np.float32),
            jax.eval_shape(lambda: init(key, cfg))))
        image, carry, rows = _frame(21, 64, 64), detection.params_from_jax, 10
    jop, top = jops.make_detector(), tops.make_detector(device="cpu")
    assert top.host == jop.host is False
    pairs = _step_both(jop, top, {"image": image}, carry=carry, jit=True)
    _equal(pairs, tol=1e-4)
    tout = pairs[0][1]
    assert tout["boxes"].shape == (rows, 4) and tout["classes"].dtype == np.int32


def test_make_translator_tiny_matches(env):
    from dora_tpu_torch.models import translation

    env.setenv("DORA_MAX_NEW_TOKENS", "40")  # clamped at the cache's 16
    text = np.frombuffer("the cat sat on the mat, ünïcødé".encode(), dtype=np.uint8)
    pairs = _step_both(jops.make_translator(), tops.make_translator(device="cpu"),
                       [{"text": text}, {"text": np.tile(text, 3)}],
                       carry=translation.params_from_jax, jit=True)
    _equal(pairs)
    assert pairs[0][1]["tokens"].shape == (16,)


@pytest.mark.parametrize("style", [None, "3"])
def test_make_tts_tiny_matches(env, style):
    from dora_tpu_torch.models import tts

    if style:
        env.setenv("DORA_TTS_STYLE", style)
    text = np.random.default_rng(22).integers(0, 300, size=9).astype(np.int32)
    pairs = _step_both(jops.make_tts(), tops.make_tts(device="cpu"), {"text": text},
                       carry=tts.params_from_jax, jit=True)
    _equal(pairs, tol=1e-4)


def test_make_tts_vits_matches(env, tmp_path):
    from transformers import VitsConfig, VitsModel

    config = VitsConfig(
        vocab_size=40, hidden_size=32, num_hidden_layers=2, num_attention_heads=2, ffn_dim=64,
        window_size=2, flow_size=16, spectrogram_bins=9, duration_predictor_filter_channels=24,
        duration_predictor_num_flows=2, duration_predictor_flow_bins=4,
        depth_separable_num_layers=2, prior_encoder_num_flows=2,
        prior_encoder_num_wavenet_layers=2, wavenet_kernel_size=3,
        upsample_initial_channel=16, upsample_rates=[4, 4], upsample_kernel_sizes=[8, 8],
        resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1, 3]], noise_scale=0.0,
        noise_scale_duration=0.0)
    torch.manual_seed(31)
    VitsModel(config).eval().save_pretrained(tmp_path, safe_serialization=True)
    env.setenv("DORA_HF_CHECKPOINT", str(tmp_path))
    jop, top = jops.make_tts(), tops.make_tts(device="cpu")
    assert top.host and jop.host
    text = np.frombuffer(b"Hello, World", dtype=np.uint8)
    pairs = _step_both(jop, top, [{"text": text}, {"text": text[:5]}], carry=False)
    _equal(pairs, tol=1e-4)
    assert pairs[0][1]["audio"].shape[0] > pairs[1][1]["audio"].shape[0] > 0
