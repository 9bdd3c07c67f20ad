"""The port's text-to-speech against dora_tpu's, on the CPU, in f32.

* ``tts._deconv`` against ``lax.conv_transpose(..., "SAME")`` (LOI, kernel
  unflipped) at (width, stride) pairs, odd widths and strides above the
  width included, the JAX kernel relaid by ``tts.deconv_from_jax``: the
  length exactly, the values within 1e-5 of the largest.
* The self-contained TTS (``TTSConfig.tiny``) on a JAX parameter tree of
  ``init_params``' shapes (seeded numpy values) carried over by
  ``tts.params_from_jax``: ``encode_text``, ``decode_frames``, ``vocode``
  and ``synthesize`` within 1e-4 rel RMS.
* VITS with the stochastic and the plain duration predictor, on the tiny
  checkpoints ``transformers`` builds offline (tests/test_hf_parity.py's
  configuration: noise scales 0): the tree within 1e-6 (the weight-norm
  fold sums in another order; both saved forms), ``encode_text`` within
  1e-4 rel RMS, the durations exactly, ``synthesize``'s waveform (same
  length) within 1e-4 rel RMS, and ``synthesize_bucketed``: the frame
  count exactly, the real prefix against the port's ``synthesize`` and the
  JAX package's bucketed waveform within 1e-4 rel RMS.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dora_tpu.models import tts as jtts
from dora_tpu.models.hf import vits as jvits
from dora_tpu_torch.models import tts as ttts
from dora_tpu_torch.models.hf import vits as tvits

transformers = pytest.importorskip("transformers")

REL_RMS = 1e-4  # f32 floats: convolutions and products summed in another order


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel_rms(got, want):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape
    return float(np.sqrt(np.mean((got - want) ** 2)) / max(np.sqrt(np.mean(want ** 2)), 1e-30))


@pytest.mark.parametrize("width,stride", [(2, 1), (3, 2), (4, 2), (5, 2), (3, 3), (2, 3),
                                          (7, 3), (1, 4), (16, 8), (5, 5)])
def test_deconv_matches_lax_conv_transpose(width, stride):
    rng = np.random.default_rng(width * 10 + stride)
    for n in (1, 5, 8):
        x = rng.standard_normal((2, n, 3)).astype(np.float32)
        w = rng.standard_normal((width, 4, 3)).astype(np.float32)  # LOI
        want = np.asarray(jtts._deconv(jnp.asarray(x), jnp.asarray(w), stride))
        got = ttts._deconv(torch.from_numpy(x).transpose(1, 2),
                           ttts.deconv_from_jax(torch.from_numpy(w)), stride).transpose(1, 2)
        assert got.shape == want.shape == (2, n * stride, 4)
        np.testing.assert_allclose(_np(got), want, rtol=0, atol=1e-5 * np.abs(want).max())


def _seeded(init_params, cfg, seed: int):
    """A tree of ``init_params``' shapes with seeded numpy values (normal,
    std 0.1): its jax.random draws would compile op by op."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: init_params(jax.random.PRNGKey(seed), cfg))
    return jax.tree.map(lambda s: (rng.standard_normal(s.shape) * 0.1).astype(np.float32),
                        shapes)


@jax.jit
def _jax_tts(params, text, style):
    cfg = jtts.TTSConfig.tiny()
    enc = jtts.encode_text(params, cfg, text, style)
    mel = jtts.decode_frames(params, cfg, enc)
    return enc, mel, jtts.vocode(params, cfg, mel)  # the last: synthesize's


def test_tts_matches():
    cfg = jtts.TTSConfig.tiny()
    assert ttts.TTSConfig.tiny() == ttts.TTSConfig(**vars(cfg))
    jparams = _seeded(jtts.init_params, cfg, 8)
    tparams = ttts.params_from_jax(jparams, device="cpu")
    assert ttts.param_count(tparams) == jtts.param_count(jparams)
    text = np.random.default_rng(9).integers(0, cfg.vocab, size=(2, cfg.max_text))
    style = np.array([1, 6])
    jenc, jmel, want = _jax_tts(jparams, jnp.asarray(text), jnp.asarray(style))
    tenc = ttts.encode_text(tparams, cfg, torch.from_numpy(text), torch.from_numpy(style))
    assert _rel_rms(tenc, jenc) < REL_RMS
    assert _rel_rms(ttts.decode_frames(tparams, cfg, tenc), jmel) < REL_RMS
    assert _rel_rms(ttts.vocode(tparams, cfg, torch.from_numpy(np.array(jmel))), want) < REL_RMS
    got = ttts.synthesize(tparams, cfg, torch.from_numpy(text), torch.from_numpy(style))
    assert got.dtype == torch.float32 and got.shape == (2, cfg.max_samples)
    assert _rel_rms(got, want) < REL_RMS


def _vits_config(stochastic: bool):
    from transformers import VitsConfig

    return VitsConfig(
        vocab_size=40, hidden_size=32, num_hidden_layers=2, num_attention_heads=2, ffn_dim=64,
        ffn_kernel_size=3, window_size=2, flow_size=16, spectrogram_bins=9,
        duration_predictor_kernel_size=3, duration_predictor_filter_channels=24,
        use_stochastic_duration_prediction=stochastic, duration_predictor_num_flows=2,
        duration_predictor_flow_bins=4, depth_separable_num_layers=2,
        depth_separable_channels=2, prior_encoder_num_flows=2,
        prior_encoder_num_wavenet_layers=2, wavenet_kernel_size=3,
        upsample_initial_channel=16, upsample_rates=[4, 4], upsample_kernel_sizes=[8, 8],
        resblock_kernel_sizes=[3], resblock_dilation_sizes=[[1, 3]], noise_scale=0.0,
        noise_scale_duration=0.0, num_speakers=1, speaker_embedding_size=0,
    )


@pytest.fixture(scope="module", params=[True, False], ids=["stochastic", "plain"])
def vits_dir(request, tmp_path_factory):
    from transformers import VitsModel

    torch.manual_seed(31)
    path = tmp_path_factory.mktemp(f"vits-torch-{request.param}")
    VitsModel(_vits_config(request.param)).eval().save_pretrained(path, safe_serialization=True)
    return path


def _walk(j, t, path=""):
    if isinstance(j, dict):
        assert set(j) == set(t), path
        for key in j:
            _walk(j[key], t[key], f"{path}/{key}")
    else:
        np.testing.assert_allclose(_np(t), np.asarray(j, np.float32), rtol=1e-6, atol=1e-7,
                                   err_msg=path)


def test_vits_matches(vits_dir):
    from dora_tpu_torch.models.hf.loader import read_safetensors

    jcfg, jparams = jvits.load(vits_dir)
    tcfg, tparams = tvits.load(vits_dir, device="cpu")
    assert tcfg == tvits.VitsConfig(**vars(jcfg)) and tcfg.noise_scale == 0.0
    _walk(jparams, tparams)
    # the legacy weight-norm names fold to the same weights
    tensors = read_safetensors(vits_dir)
    legacy = {}
    for name, v in tensors.items():
        name = name.replace(".parametrizations.weight.original0", ".weight_g")
        legacy[name.replace(".parametrizations.weight.original1", ".weight_v")] = v
    assert any(k.endswith(".weight_g") for k in legacy)
    _walk(jparams, tvits.map_params(legacy, tcfg))

    ids = np.random.default_rng(33).integers(1, tcfg.vocab, size=(1, 9))
    jh, jm, jl = jvits.encode_text(jparams, jcfg, ids)
    th, tm, tl = tvits.encode_text(tparams, tcfg, torch.from_numpy(ids))
    for got, want in ((th, jh), (tm, jm), (tl, jl)):
        assert _rel_rms(got, want) < REL_RMS
    jdur = jvits.predict_log_duration(jparams, jcfg, jh)
    tdur = tvits.predict_log_duration(tparams, tcfg, th)
    assert _rel_rms(tdur, jdur) < REL_RMS
    want_rep = np.ceil(np.exp(np.asarray(jdur[:, 0])) / jcfg.speaking_rate).astype(np.int64)
    np.testing.assert_array_equal(tvits.durations(tdur, tcfg.speaking_rate), want_rep)

    want = jvits.synthesize(jparams, jcfg, ids)
    got = tvits.synthesize(tparams, tcfg, torch.from_numpy(ids))
    assert got.shape == want.shape == (1, int(want_rep.sum()) * tvits.upsample_factor(tcfg))
    assert _rel_rms(got, want) < REL_RMS


@pytest.mark.parametrize("length", [5, 23])
def test_vits_bucketed_matches(vits_dir, length):
    jcfg, jparams = jvits.load(vits_dir)
    tcfg, tparams = tvits.load(vits_dir, device="cpu")
    ids = np.random.default_rng(35 + length).integers(1, tcfg.vocab, size=(1, length))
    buckets = {"text_buckets": (16, 32), "frame_buckets": (256, 1024, 4096)}
    plain = tvits.synthesize(tparams, tcfg, torch.from_numpy(ids))
    got = tvits.synthesize_bucketed(tparams, tcfg, torch.from_numpy(ids), **buckets)
    want = jvits.synthesize_bucketed(jparams, jcfg, ids, **buckets)
    assert got.shape == plain.shape == want.shape  # the same frame count
    assert _rel_rms(got, plain) < REL_RMS and _rel_rms(got, want) < REL_RMS
    # prior noise from a generator: the same seed gives the same waveform
    noisy = [tvits.synthesize_bucketed(tparams, tcfg, torch.from_numpy(ids), noise_scale=0.5,
                                       generator=torch.Generator().manual_seed(3), **buckets)
             for _ in range(2)]
    assert torch.equal(noisy[0], noisy[1]) and not torch.equal(noisy[0], got)
