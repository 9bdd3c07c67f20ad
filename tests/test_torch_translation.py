"""The port's translators against dora_tpu's, on the CPU, in f32.

* The sentencepiece segmenter (models/spm.py, the port's own copy): the
  parsed table, the serialized bytes and the pieces of every probe text
  (unknown characters, the word-boundary marker itself, runs of spaces,
  non-ASCII) exactly the JAX copy's; ``MarianTokenizer``'s ids exactly, and
  its round trip.
* The self-contained translator (``TranslatorConfig.tiny``) on a JAX
  parameter tree of ``init_params``' shapes (seeded numpy values) carried
  over by ``translation.params_from_jax``: ``encode`` within 1e-4 rel RMS,
  ``translate`` token for token.
* Marian on the tiny checkpoint ``transformers`` builds offline (the
  fixture of tests/test_hf_parity.py): the tree value for value, ``forward``
  within 1e-4 rel RMS, ``translate`` token for token over every emitted
  position (past the first EOS too) with and without ``src_mask`` and
  ``forced_eos_token``, and ``translate_speculative`` token for token with
  the JAX loop's pass count.
"""

from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dora_tpu.models import spm as jspm
from dora_tpu.models import translation as jtr
from dora_tpu.models.hf import marian as jmarian
from dora_tpu_torch.models import spm as tspm
from dora_tpu_torch.models import translation as ttr
from dora_tpu_torch.models.hf import marian as tmarian

transformers = pytest.importorskip("transformers")

REL_RMS = 1e-4  # f32 floats: products summed in another order

PIECES = [
    ("<unk>", 0.0, tspm.TYPE_UNKNOWN), ("<s>", 0.0, tspm.TYPE_CONTROL),
    ("</s>", 0.0, tspm.TYPE_CONTROL), ("▁", -4.0, tspm.TYPE_NORMAL),
    ("▁the", -1.0, tspm.TYPE_NORMAL), ("▁cat", -2.0, tspm.TYPE_NORMAL),
    ("▁dog", -2.2, tspm.TYPE_NORMAL), ("▁sat", -2.4, tspm.TYPE_NORMAL),
    ("s", -3.0, tspm.TYPE_NORMAL), ("a", -3.1, tspm.TYPE_NORMAL),
    ("t", -3.2, tspm.TYPE_NORMAL), ("c", -3.3, tspm.TYPE_NORMAL),
    ("▁ca", -3.4, tspm.TYPE_NORMAL), ("über", -2.5, tspm.TYPE_USER_DEFINED),
    ("unused", -1.0, tspm.TYPE_UNUSED),
]
PROBES = ["", "the cat sat", "the cats", "the x", "the zebra sat on the dog", "  the  cat ",
          "cat", "ca t", "übercat", "the ▁cat", "▁", "tttt sss", "dog\tcat", "ünïcødé ✓"]


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel_rms(got, want):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    assert got.shape == want.shape
    return float(np.sqrt(np.mean((got - want) ** 2)) / max(np.sqrt(np.mean(want ** 2)), 1e-30))


def test_spm_matches_the_jax_copy(tmp_path):
    blob = tspm.build_model_proto(PIECES)
    assert blob == jspm.build_model_proto(PIECES)
    (tmp_path / "m.spm").write_bytes(blob)
    table = tspm.parse_model(tmp_path / "m.spm")
    assert table == jspm.parse_model(tmp_path / "m.spm")
    assert [p for p, _, _ in table] == [p for p, _, _ in PIECES]
    ours, theirs = tspm.SentencePieceModel(table), jspm.SentencePieceModel(table)
    for text in PROBES:
        assert ours.encode(text) == theirs.encode(text), text
        assert ours.decode(ours.encode(text)) == theirs.decode(theirs.encode(text)), text
    assert ours.encode("the cats") == ["▁the", "▁cat", "s"]
    assert ours.encode("the x") == ["▁the", "▁", "x"]  # the unknown character alone


@pytest.fixture(scope="module")
def marian_dir(tmp_path_factory):
    from transformers import MarianConfig, MarianMTModel

    config = MarianConfig(
        vocab_size=97, d_model=32, encoder_layers=2, decoder_layers=2,
        encoder_attention_heads=4, decoder_attention_heads=4, encoder_ffn_dim=64,
        decoder_ffn_dim=64, max_position_embeddings=64, scale_embedding=True,
        activation_function="swish", pad_token_id=96, eos_token_id=0,
        decoder_start_token_id=96,
    )
    torch.manual_seed(7)
    path = tmp_path_factory.mktemp("marian-torch")
    MarianMTModel(config).eval().save_pretrained(path, safe_serialization=True)
    blob = tspm.build_model_proto(PIECES[:13])
    (path / "source.spm").write_bytes(blob)
    (path / "target.spm").write_bytes(blob)
    vocab = {"<unk>": 1, "</s>": 0, "<pad>": 96}
    for piece, _, _ in PIECES[:13]:
        vocab.setdefault(piece, len(vocab) + 1)
    (path / "vocab.json").write_text(json.dumps(vocab))
    return path


def test_marian_tokenizer_matches(marian_dir):
    ours, theirs = tmarian.MarianTokenizer(marian_dir), jmarian.MarianTokenizer(marian_dir)
    for text in PROBES:
        ids = ours.encode(text)
        assert ids == theirs.encode(text), text
        assert ours.decode(ids) == theirs.decode(ids), text
    ids = ours.encode("the cat sat")
    assert ids[-1] == ours.eos_id and ours.decode(ids) == "the cat sat"
    assert ours.unk_id in ours.encode("the zebra")


def test_translator_matches():
    cfg = jtr.TranslatorConfig.tiny()
    assert ttr.TranslatorConfig.tiny() == ttr.TranslatorConfig(**vars(cfg))
    rng = np.random.default_rng(5)  # init_params' shapes; its jax.random draws compile slowly
    jparams = jax.tree.map(lambda s: (rng.standard_normal(s.shape) * 0.1).astype(np.float32),
                           jax.eval_shape(lambda: jtr.init_params(jax.random.PRNGKey(5), cfg)))
    tparams = ttr.params_from_jax(jparams, device="cpu")
    src = np.random.default_rng(6).integers(0, cfg.vocab, size=(2, cfg.max_src)).astype(np.int32)
    assert _rel_rms(ttr.encode(tparams, cfg, torch.from_numpy(src)),
                    jax.jit(jtr.encode, static_argnums=1)(jparams, cfg, jnp.asarray(src))) < REL_RMS
    want = np.asarray(jtr.translate(jparams, cfg, jnp.asarray(src), 256 % cfg.vocab, 12))
    got = ttr.translate(tparams, cfg, torch.from_numpy(src), 256 % cfg.vocab, 12)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), want)
    with pytest.raises(ValueError, match="KV-cache capacity"):
        ttr.translate(tparams, cfg, torch.from_numpy(src), 1, cfg.max_tokens + 1)


@pytest.fixture(scope="module")
def marian_pair(marian_dir):
    jcfg, jparams = jmarian.load(marian_dir, max_tokens=16)
    tcfg, tparams = tmarian.load(marian_dir, max_tokens=16, device="cpu")
    return jcfg, jparams, tcfg, tparams


def _walk(j, t, path=""):
    if isinstance(j, dict):
        assert set(j) == set(t), path
        for key in j:
            _walk(j[key], t[key], f"{path}/{key}")
    else:
        np.testing.assert_array_equal(_np(t), np.asarray(j, np.float32), err_msg=path)


def test_marian_forward_matches(marian_pair):
    jcfg, jparams, tcfg, tparams = marian_pair
    assert tcfg == tmarian.MarianConfig(**vars(jcfg)) and tcfg.forced_eos_token == 0
    _walk(jparams, tparams)
    rng = np.random.default_rng(3)
    src = rng.integers(1, 90, (2, 7)).astype(np.int32)
    dec = rng.integers(1, 90, (2, 5)).astype(np.int32)
    dec[:, 0] = tcfg.decoder_start_token
    got = tmarian.forward(tparams, tcfg, torch.from_numpy(src), torch.from_numpy(dec))
    assert got.dtype == torch.float32
    assert _rel_rms(got, jmarian.forward(jparams, jcfg, src, dec)) < REL_RMS


def _source(pad_to=10):
    real = np.array([[5, 9, 23, 41, 2, 0], [7, 7, 30, 0, 0, 0]], np.int32)
    src = np.full((2, pad_to), 96, np.int32)
    src[:, :6] = real
    mask = np.arange(pad_to)[None, :] < np.array([[6], [4]])
    return src, mask


@pytest.mark.parametrize("masked", [True, False], ids=["src_mask", "no-mask"])
@pytest.mark.parametrize("forced", [0, None], ids=["forced-eos", "no-forced-eos"])
def test_marian_translate_matches(marian_pair, masked, forced):
    jcfg, jparams, tcfg, tparams = marian_pair
    jcfg = dataclasses.replace(jcfg, forced_eos_token=forced)
    tcfg = dataclasses.replace(tcfg, forced_eos_token=forced)
    src, mask = _source()
    want = np.asarray(jmarian.translate(jparams, jcfg, jnp.asarray(src), 12,
                                        src_mask=jnp.asarray(mask) if masked else None))
    got = tmarian.translate(tparams, tcfg, torch.from_numpy(src), 12,
                            src_mask=torch.from_numpy(mask) if masked else None)
    assert got.dtype == torch.int32 and got.shape == (2, 12)
    np.testing.assert_array_equal(_np(got), want)  # every position, past EOS too
    if forced is not None:
        assert (_np(got)[:, -1] == forced).all()
    with pytest.raises(ValueError, match="KV-cache capacity"):
        tmarian.translate(tparams, tcfg, torch.from_numpy(src), 17)


@pytest.mark.parametrize("masked", [True, False], ids=["src_mask", "no-mask"])
def test_marian_speculative_matches(marian_pair, masked):
    jcfg, jparams, tcfg, tparams = marian_pair
    src, mask = _source()
    src, mask = src[1:], mask[1:]
    jmask = jnp.asarray(mask) if masked else None
    tmask = torch.from_numpy(mask) if masked else None
    want, want_passes = jmarian.translate_speculative(jparams, jcfg, jnp.asarray(src), 10,
                                                      src_mask=jmask)
    got, passes = tmarian.translate_speculative(tparams, tcfg, torch.from_numpy(src), 10,
                                                src_mask=tmask)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    assert passes == int(want_passes)
    greedy = tmarian.translate(tparams, tcfg, torch.from_numpy(src), 10, src_mask=tmask)
    np.testing.assert_array_equal(_np(got), _np(greedy))
    with pytest.raises(ValueError, match="headroom"):
        tmarian.translate_speculative(tparams, tcfg, torch.from_numpy(src), 12)
