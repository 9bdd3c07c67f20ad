"""The port's speech models against dora_tpu's, on the CPU, in f32.

* Wav2Vec2 (the VAD class) on the tiny checkpoint that ``transformers``
  builds offline (tests/test_hf_parity.py's fixture), loaded by both
  packages: the tree value for value, ``feature_extractor``, ``forward``
  and ``speech_probability`` within 1e-5 of the largest value, and the
  weight-norm rebuild of either saved form.
* The self-contained ASR on the JAX package's ``init_params`` carried over
  by ``params_from_jax``: the mel filters exactly, ``log_mel`` and
  ``encode`` within 1e-5 of the largest value, ``transcribe`` token for
  token.
* The GRU VAD on carried parameters over three chunks, the hidden state
  threaded from chunk to chunk: probabilities and state within 1e-5, and
  ``segment_speech``.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from dora_tpu.models import asr as jasr
from dora_tpu.models import vad as jvad
from dora_tpu.models.hf import wav2vec2 as jw2v
from dora_tpu_torch.models import asr as tasr
from dora_tpu_torch.models import vad as tvad
from dora_tpu_torch.models.hf import wav2vec2 as tw2v
from dora_tpu_torch.models.hf.qwen2 import params_from_jax

transformers = pytest.importorskip("transformers")


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol=1e-5):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def wav2vec2_checkpoint(tmp_path_factory):
    from transformers import Wav2Vec2Config, Wav2Vec2ForAudioFrameClassification

    config = Wav2Vec2Config(
        vocab_size=32, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=64, conv_dim=[16, 16, 32], conv_stride=[5, 2, 2],
        conv_kernel=[10, 3, 3], num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4,
        num_labels=2, do_stable_layer_norm=False, feat_extract_norm="group",
    )
    torch.manual_seed(11)
    model = Wav2Vec2ForAudioFrameClassification(config).eval()
    path = tmp_path_factory.mktemp("wav2vec2-torch")
    model.save_pretrained(path, safe_serialization=True)
    return path


def _walk(j, t, path=""):
    if isinstance(j, dict):
        assert set(j) == set(t), path
        for key in j:
            _walk(j[key], t[key], f"{path}/{key}")
    else:
        np.testing.assert_allclose(_np(t), np.asarray(j, np.float32), rtol=1e-6, atol=1e-7,
                                   err_msg=path)


def test_wav2vec2_matches(wav2vec2_checkpoint):
    jcfg, jparams = jw2v.load(wav2vec2_checkpoint)
    tcfg, tparams = tw2v.load(wav2vec2_checkpoint, device="cpu")
    assert tcfg == tw2v.Wav2Vec2Config(**vars(jcfg))
    _walk(jparams, tparams)  # the weight-norm rebuild sums in another order
    audio = np.random.default_rng(0).standard_normal((2, 4000)).astype(np.float32)
    _close(tw2v.feature_extractor(tparams, tcfg, torch.from_numpy(audio)),
           jw2v.feature_extractor(jparams, jcfg, audio))
    _close(tw2v.forward(tparams, tcfg, torch.from_numpy(audio)),
           jw2v.forward(jparams, jcfg, audio))
    audio = np.random.default_rng(5).standard_normal((1, 3200)).astype(np.float32)
    probs = tw2v.speech_probability(tparams, tcfg, torch.from_numpy(audio))
    _close(probs, jw2v.speech_probability(jparams, jcfg, audio))
    assert probs.dtype == torch.float32


def test_weight_norm_forms_match():
    rng = np.random.default_rng(3)
    g = rng.random((1, 1, 4)).astype(np.float32)
    v = rng.standard_normal((6, 3, 4)).astype(np.float32)
    want = jw2v._weight_norm_conv({"c.weight_g": g, "c.weight_v": v}, "c.")
    for names in (("weight_g", "weight_v"),
                  ("parametrizations.weight.original0", "parametrizations.weight.original1")):
        got = tw2v._weight_norm_conv({f"c.{names[0]}": torch.from_numpy(g),
                                      f"c.{names[1]}": torch.from_numpy(v)}, "c.")
        np.testing.assert_allclose(_np(got), want, rtol=1e-6)


@pytest.fixture(scope="module")
def asr_models():
    cfg = jasr.ASRConfig.tiny()
    jparams = jasr.init_params(jax.random.PRNGKey(0), cfg)
    return cfg, jparams, tasr.ASRConfig.tiny(), params_from_jax(jparams, device="cpu")


def test_asr_init_params_shapes(asr_models):
    _, jparams, tcfg, _ = asr_models
    mine = tasr.init_params(tcfg, seed=0, device="cpu")

    def walk(j, t, path=""):
        if isinstance(j, dict):
            assert set(j) == set(t), path
            for key in j:
                walk(j[key], t[key], f"{path}/{key}")
        else:
            assert tuple(j.shape) == tuple(t.shape) and t.dtype == torch.float32, path

    walk(jparams, mine)


@pytest.mark.parametrize("n", [9000, 400, 16000])
def test_asr_frontend_and_encoder_match(asr_models, n):
    jcfg, jparams, tcfg, tparams = asr_models
    np.testing.assert_array_equal(_np(tasr.mel_filterbank(tcfg, "cpu")),
                                  np.asarray(jasr.mel_filterbank(jcfg)))
    audio = (np.random.default_rng(n).normal(size=(2, n)) * 0.3).astype(np.float32)
    jmel = jasr.log_mel(jcfg, audio)
    tmel = tasr.log_mel(tcfg, torch.from_numpy(audio))
    _close(tmel, jmel)
    _close(tasr.encode(tparams, tcfg, tmel), jasr.encode(jparams, jcfg, jmel))


@pytest.mark.parametrize("b,max_new", [(1, 16), (2, 7), (1, 0)])
def test_asr_transcribe_matches(asr_models, b, max_new):
    jcfg, jparams, tcfg, tparams = asr_models
    audio = (np.random.default_rng(b + max_new).normal(size=(b, 8000)) * 0.3).astype(np.float32)
    want = np.asarray(jasr.transcribe(jparams, jcfg, audio, 3, max_new))
    got = tasr.transcribe(tparams, tcfg, torch.from_numpy(audio), 3, max_new)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("tiny", [True, False])
def test_vad_threads_state_across_chunks(tiny):
    jcfg = jvad.VADConfig.tiny() if tiny else jvad.VADConfig()
    tcfg = tvad.VADConfig.tiny() if tiny else tvad.VADConfig()
    jparams = jvad.init_params(jax.random.PRNGKey(1), jcfg)
    tparams = params_from_jax(jparams, device="cpu")
    rng = np.random.default_rng(2)
    jh, th = None, None
    probs = []
    for chunk in range(3):
        audio = (rng.normal(size=(1, 1600 + 512 * chunk)) * (0.05 + chunk)).astype(np.float32)
        jp, jh = jvad.speech_prob(jparams, jcfg, audio, jh)
        tp, th = tvad.speech_prob(tparams, tcfg, torch.from_numpy(audio), th)
        _close(tp, jp)
        _close(th, jh)
        probs.append(float(_np(tp)[0]))
    track = np.asarray([0.9, 0.1, 0.8, 0.2, 0.1, 0.7] + probs, np.float32)
    np.testing.assert_array_equal(tvad.segment_speech(torch.from_numpy(track)),
                                  jvad.segment_speech(track))
