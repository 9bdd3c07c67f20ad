"""The port's tokenizer and the serving entry's end-of-turn token, on the CPU.

The port's copy of ``BPETokenizer`` (dora_tpu_torch/models/tokenizer.py)
encodes as the upstream ``tokenizers`` library does on a byte-level BPE
trained offline here (the JAX package's fixture of tests/test_hf_parity.py),
round-trips text, honours a Qwen2-style split pre-tokenizer, and encodes as
the JAX package's copy does. ``llm_server.main`` on a tiny ``transformers``
Qwen2 checkpoint with such a tokenizer picks ``<|im_end|>`` as its EOS (the
JAX server's order) and a greedy stream stops there; without a tokenizer
the same stream runs to ``--max-new``.
"""

from __future__ import annotations

import json

import pytest

from dora_tpu_torch.models import tokenizer as T
from dora_tpu_torch.nodehub import llm_server

CORPUS = [
    "the quick brown fox jumps over the lazy dog",
    "pack my box with five dozen liquor jugs",
    "sphinx of black quartz, judge my vow",
    "Hello, world! Numbers: 123 456.789 — and unicode: héllo über 日本語",
    "def main() -> int:\n    return 0\n",
] * 50
SPECIALS = ["<|endoftext|>", "<|im_start|>", "<|im_end|>"]


def _train(vocab_size: int):
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, trainers

    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(
        vocab_size=vocab_size, special_tokens=SPECIALS,
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet(), show_progress=False,
    )
    tok.train_from_iterator(CORPUS, trainer)
    return tok


@pytest.fixture(scope="module")
def trained_bpe(tmp_path_factory):
    tok = _train(400)
    path = tmp_path_factory.mktemp("bpe") / "tokenizer.json"
    tok.save(str(path))
    return path, tok


@pytest.mark.parametrize(
    "text",
    [
        "the quick brown fox",
        "Hello, world! 123",
        "unicode héllo über 日本語 test",
        "  leading spaces and\nnewlines\t tabs",
        "<|endoftext|>wrapped<|im_start|> specials <|im_end|>",
        "",
    ],
)
def test_bpe_encode_matches_tokenizers_lib_and_jax_copy(trained_bpe, text):
    from dora_tpu.models.tokenizer import BPETokenizer as JaxBPE

    path, upstream = trained_bpe
    ours = T.BPETokenizer.from_file(path)
    assert ours.encode(text) == upstream.encode(text).ids
    assert ours.encode(text) == JaxBPE.from_file(path).encode(text)


def test_bpe_decode_roundtrip(trained_bpe):
    path, upstream = trained_bpe
    ours = T.BPETokenizer.from_file(path.parent)  # a directory holding it
    text = "the quick brown fox says héllo 123"
    ids = ours.encode(text)
    assert ours.decode(ids) == text == upstream.decode(ids)
    assert len(ours) == upstream.get_vocab_size()


def test_bpe_qwen2_style_pretokenizer(tmp_path):
    """Sequence[Split(cl100k regex), ByteLevel(use_regex=False)], the
    Qwen2-family layout: the split pattern is honoured."""
    from tokenizers import Regex, Tokenizer, decoders, models, pre_tokenizers, trainers

    cl100k = (
        r"""(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}"""
        r"""| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"""
    )
    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(cl100k), behavior="isolated", invert=False),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False),
    ])
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(
        vocab_size=400, special_tokens=SPECIALS,
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet(), show_progress=False,
    )
    tok.train_from_iterator(CORPUS, trainer)
    tok.save(str(tmp_path / "tokenizer.json"))
    ours = T.BPETokenizer.from_file(tmp_path)
    for text in ("Hello, world! 12345 it's", "unicode héllo\n\nnew  lines"):
        assert ours.encode(text) == tok.encode(text).ids


def test_byte_codec():
    ids = T.encode("héllo")
    assert ids[0] == T.BOS and T.decode(ids) == "héllo"


def test_eos_token_order():
    class Tok:
        added = {"<|endoftext|>": 5, "</s>": 6, "<|im_end|>": 7}

    assert llm_server.eos_token(Tok()) == 7
    Tok.added = {"</s>": 6, "<|endoftext|>": 5}
    assert llm_server.eos_token(Tok()) == 5
    Tok.added = {"<|im_start|>": 1}
    assert llm_server.eos_token(Tok()) is None
    assert llm_server.eos_token(None) is None


VOCAB = 300
KNOBS = ("DORA_BATCH_SLOTS", "DORA_PAGE_SIZE", "DORA_PREFILL_CHUNK", "DORA_MULTISTEP_K",
         "DORA_PREFIX_CACHE", "DORA_PREFIX_CACHE_PAGES", "DORA_SPEC_K", "DORA_SPEC_NGRAM",
         "DORA_PAGED_KV", "DORA_KV_INT8", "DORA_LORA_DIR", "DORA_INT8_PURE",
         "DORA_INT4_DECODE", "DORA_WEIGHT_BITS", "DORA_FUSED_DECODE")


@pytest.fixture()
def checkpoint(tmp_path, monkeypatch):
    """A tiny random Qwen2 checkpoint of VOCAB ids (no tokenizer yet) as
    DORA_HF_CHECKPOINT, and a prompts file."""
    import torch
    from transformers import Qwen2Config, Qwen2ForCausalLM

    config = Qwen2Config(
        vocab_size=VOCAB, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
        rope_theta=10000.0, rms_norm_eps=1e-6, tie_word_embeddings=False,
    )
    torch.manual_seed(0)
    Qwen2ForCausalLM(config).eval().save_pretrained(tmp_path, safe_serialization=True)
    for knob in KNOBS:
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.setenv("DORA_HF_CHECKPOINT", str(tmp_path))
    monkeypatch.setenv("DORA_MAX_SEQ", "64")
    prompts = tmp_path / "prompts.json"
    prompts.write_text(json.dumps([[11, 42, 7, 99, 3]]))
    return tmp_path, prompts


def _serve(prompts, capsys, max_new=12):
    assert llm_server.main(["--prompts", str(prompts), "--max-new", str(max_new),
                            "--device", "cpu"]) == 0
    (line,) = capsys.readouterr().out.strip().splitlines()
    return json.loads(line)["tokens"]


def test_main_stops_a_stream_at_the_tokenizers_im_end(checkpoint, capsys):
    """Without a tokenizer the stream runs to --max-new. A BPE trained
    offline, its <|im_end|> id moved to the token the model emits at some
    step j (swapped with the id that held it, so ids stay unique), then ends
    the same stream right after step j; <|endoftext|> is in the tokenizer
    too, and <|im_end|> comes first in the JAX server's order."""
    ckpt, prompts = checkpoint
    stream = _serve(prompts, capsys)
    assert len(stream) == 12
    j = next(i for i in range(2, 12) if stream[i] not in stream[:i])
    eos = stream[j]

    spec = json.loads(_train(VOCAB).to_str())
    old = next(t["id"] for t in spec["added_tokens"] if t["content"] == "<|im_end|>")
    vocab = spec["model"]["vocab"]
    holder = next(name for name, i in vocab.items() if i == eos)
    vocab[holder], vocab["<|im_end|>"] = old, eos
    for t in spec["added_tokens"]:
        if t["content"] == holder:
            t["id"] = old
        elif t["content"] == "<|im_end|>":
            t["id"] = eos
    (ckpt / "tokenizer.json").write_text(json.dumps(spec))

    tok = T.BPETokenizer.from_file(ckpt)
    assert "<|endoftext|>" in tok.added and tok.added["<|im_end|>"] == eos
    assert llm_server.eos_token(tok) == eos
    assert _serve(prompts, capsys) == stream[: j + 1]


def test_main_passes_the_eos_it_picks_to_make_engine(checkpoint, capsys, monkeypatch):
    ckpt, prompts = checkpoint
    _train(VOCAB).save(str(ckpt / "tokenizer.json"))
    want = T.BPETokenizer.from_file(ckpt).added["<|im_end|>"]
    seen = {}
    real = llm_server.make_engine

    def spy(params, cfg, eos=None, device=None):
        seen["eos"] = eos
        return real(params, cfg, eos=eos, device=device)

    monkeypatch.setattr(llm_server, "make_engine", spy)
    _serve(prompts, capsys, max_new=2)
    assert seen["eos"] == want
