"""The port's Whisper against dora_tpu's, on the CPU.

Both packages load the same tiny checkpoint, which ``transformers`` builds
offline with random weights (the fixture of tests/test_hf_parity.py). In
f32 (both packages' CPU compute dtype):

* ``map_params`` gives the JAX package's tree, value for value;
* the slaney filters are equal, ``log_mel_features`` (numpy in both) equal,
  and ``log_mel_traced`` within 1e-5 of the largest value (torch's and
  XLA's FFTs sum in another order);
* ``encode`` and ``decoder_logits`` within 1e-5 of the largest value;
* greedy and speculative ``transcribe_tokens`` (with the speculative pass
  count) and ``make_serving_step`` token for token, forced prefixes too;
* ``trim_after_eos`` and the max_target guard.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from dora_tpu.models.hf import whisper as jw
from dora_tpu_torch.models.hf import whisper as tw

transformers = pytest.importorskip("transformers")


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    from transformers import WhisperConfig, WhisperForConditionalGeneration

    config = WhisperConfig(
        vocab_size=200, num_mel_bins=32, d_model=64, encoder_layers=2, decoder_layers=2,
        encoder_attention_heads=4, decoder_attention_heads=4, encoder_ffn_dim=128,
        decoder_ffn_dim=128, max_source_positions=50, max_target_positions=32,
        decoder_start_token_id=3, eos_token_id=2, bos_token_id=1, pad_token_id=0,
        suppress_tokens=[], begin_suppress_tokens=[], attn_implementation="eager",
    )
    torch.manual_seed(4)
    model = WhisperForConditionalGeneration(config).eval()
    path = tmp_path_factory.mktemp("whisper-torch")
    model.save_pretrained(path, safe_serialization=True)
    return path


@pytest.fixture(scope="module")
def models(checkpoint):
    jcfg, jparams = jw.load(checkpoint)
    tcfg, tparams = tw.load(checkpoint, device="cpu")
    return jcfg, jparams, tcfg, tparams


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol=1e-5):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-30))


def _feats(cfg, seed, b=1):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(b, cfg.n_mels, 2 * cfg.max_source)).astype(np.float32)


def test_config_and_tree_match(models):
    jcfg, jparams, tcfg, tparams = models
    assert tcfg == tw.WhisperConfig(**vars(jcfg))

    def walk(j, t, path=""):
        if isinstance(j, dict):
            assert set(j) == set(t), path
            for key in j:
                walk(j[key], t[key], f"{path}/{key}")
        else:
            np.testing.assert_array_equal(_np(t), np.asarray(j, np.float32), err_msg=path)

    walk(jparams, tparams)


def test_mel_frontend_matches(models):
    jcfg = models[0]
    np.testing.assert_array_equal(tw.slaney_mel_filters(201, 32), jw.slaney_mel_filters(201, 32))
    rng = np.random.default_rng(8)
    audio = (rng.normal(size=(2, 16000)) * 0.1).astype(np.float32)
    n_samples = jcfg.max_source * 2 * 160
    np.testing.assert_array_equal(tw.log_mel_features(audio, 32, n_samples=n_samples),
                                  jw.log_mel_features(audio, 32, n_samples=n_samples))
    want = jw.log_mel_traced(audio, 32, n_samples=n_samples)
    got = tw.log_mel_traced(torch.from_numpy(audio), 32, n_samples=n_samples)
    _close(got, want)
    # the 30 s default window, and audio longer than it (trimmed)
    long = (rng.normal(size=(1, 480000 + 321)) * 0.1).astype(np.float32)
    _close(tw.log_mel_traced(torch.from_numpy(long), 32), jw.log_mel_traced(long, 32))


def test_encode_and_decoder_logits_match(models):
    jcfg, jparams, tcfg, tparams = models
    feats = _feats(jcfg, 5, b=2)
    jenc = jw.encode(jparams, jcfg, feats)
    tenc = tw.encode(tparams, tcfg, torch.from_numpy(feats))
    _close(tenc, jenc)
    ids = np.random.default_rng(6).integers(0, jcfg.vocab, size=(2, 9)).astype(np.int32)
    _close(tw.decoder_logits(tparams, tcfg, tenc, torch.from_numpy(ids)),
           jw.decoder_logits(jparams, jcfg, jenc, ids))


@pytest.mark.parametrize("max_new,forced", [(10, None), (1, None), (0, None),
                                            (12, [[3, 7, 9]])])
def test_greedy_tokens_match(models, max_new, forced):
    jcfg, jparams, tcfg, tparams = models
    feats = _feats(jcfg, 7)
    jforced = None if forced is None else np.asarray(forced, np.int32)
    want = np.asarray(jw.transcribe_tokens(jparams, jcfg, feats, max_new, jforced))
    got = tw.transcribe_tokens(tparams, tcfg, torch.from_numpy(feats), max_new, jforced)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("max_new,k", [(20, 4), (9, 2), (1, 4)])
def test_speculative_tokens_and_passes_match(models, max_new, k):
    jcfg, jparams, tcfg, tparams = models
    feats = _feats(jcfg, 9)
    jt, jp = jw.transcribe_tokens_speculative(jparams, jcfg, feats, max_new, k=k)
    tt, tp = tw.transcribe_tokens_speculative(tparams, tcfg, torch.from_numpy(feats), max_new,
                                              k=k)
    np.testing.assert_array_equal(_np(tt), np.asarray(jt))
    assert int(tp) == int(jp)
    greedy = tw.transcribe_tokens(tparams, tcfg, torch.from_numpy(feats), max_new)
    np.testing.assert_array_equal(_np(tt), _np(greedy))


@pytest.mark.parametrize("speculative", [False, True])
def test_serving_step_matches(models, speculative):
    jcfg, jparams, tcfg, tparams = models
    audio = (np.random.default_rng(11).normal(size=9000) * 0.2).astype(np.float32)
    want = np.asarray(jw.make_serving_step(jcfg, 8, speculative=speculative)(jparams, audio))
    got = tw.make_serving_step(tcfg, 8, speculative=speculative)(tparams,
                                                                 torch.from_numpy(audio))
    np.testing.assert_array_equal(_np(got), want)


def test_trim_after_eos_and_guards(models):
    tokens = np.asarray([[5, 6, 2, 7], [2, 1, 1, 1], [4, 4, 4, 4]], np.int32)
    assert tw.trim_after_eos(torch.from_numpy(tokens), 2) == jw.trim_after_eos(tokens, 2)
    jcfg, _, tcfg, tparams = models
    feats = torch.from_numpy(_feats(jcfg, 1))
    with pytest.raises(ValueError, match="max_target_positions"):
        tw.transcribe_tokens(tparams, tcfg, feats, tcfg.max_target)
    with pytest.raises(ValueError, match="batch-1"):
        tw.transcribe_tokens_speculative(tparams, tcfg, feats.repeat(2, 1, 1), 4)
