"""Tokenizers: fallback byte-level codec + real byte-level BPE.

Counterpart of dora_tpu/models/tokenizer.py (a copy: the port imports
nothing of dora_tpu). Two tiers:

* The zero-dependency byte codec (ids 0..255 + specials) keeps every
  model usable without any vocabulary files.
* :class:`BPETokenizer` loads a pretrained HuggingFace ``tokenizer.json``
  (byte-level BPE — the GPT-2/Qwen2/Whisper family) in pure Python:
  byte→unicode alphabet, GPT-2 pre-tokenization regex, rank-ordered merge
  loop, added special tokens. Parity with the upstream `tokenizers`
  library is asserted in tests/test_hf_parity.py (the JAX package's copy)
  and tests/test_torch_tokenizer.py (this one).

Reference: the reference's model nodes pull HF tokenizers through
transformers at runtime (node-hub/dora-qwenvl/dora_qwenvl/main.py:34-40).
"""

from __future__ import annotations

import json
from functools import lru_cache
from pathlib import Path

BOS = 256
EOS = 257
PAD = 258
VOCAB = 259


def encode(text: str, bos: bool = True) -> list[int]:
    ids = list(text.encode("utf-8"))
    return ([BOS] if bos else []) + ids


def decode(ids) -> str:
    data = bytes(int(i) for i in ids if 0 <= int(i) < 256)
    return data.decode("utf-8", errors="replace")


# ---------------------------------------------------------------------------
# byte-level BPE (GPT-2 family), pure Python
# ---------------------------------------------------------------------------

#: GPT-2 pre-tokenization pattern (requires the `regex` module for \p
#: classes; the stock `re` module cannot express it).
_GPT2_PATTERN = (
    r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"""
)


@lru_cache(maxsize=1)
def _bytes_to_unicode() -> dict[int, str]:
    """GPT-2's reversible byte→printable-unicode alphabet."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


class BPETokenizer:
    """Byte-level BPE loaded from a HuggingFace ``tokenizer.json``."""

    def __init__(
        self,
        vocab: dict[str, int],
        merges: list[tuple[str, str]],
        added_tokens: dict[str, int] | None = None,
        pattern: str | None = None,
        ignore_merges: bool = False,
    ):
        self.vocab = vocab
        self.inv_vocab = {v: k for k, v in vocab.items()}
        self.ranks = {pair: i for i, pair in enumerate(merges)}
        self.added = dict(added_tokens or {})
        self.ignore_merges = ignore_merges
        for token, idx in self.added.items():
            self.inv_vocab.setdefault(idx, token)
        self._byte_map = _bytes_to_unicode()
        self._byte_unmap = {c: b for b, c in self._byte_map.items()}
        import regex

        self._pattern = regex.compile(pattern or _GPT2_PATTERN)
        # Longest-first so overlapping specials split deterministically.
        self._added_sorted = sorted(self.added, key=len, reverse=True)

    # -- construction -------------------------------------------------------

    @staticmethod
    def _split_pattern(pre_tok: dict | None) -> str | None:
        """Extract the pre-tokenization split regex from a tokenizer.json
        ``pre_tokenizer`` spec. Handles the layouts the GPT-2/Qwen2/Llama-3
        families use: a bare ByteLevel (GPT-2 regex when use_regex), a
        Split with an explicit Regex pattern (cl100k-style), or a Sequence
        combining them."""
        if pre_tok is None:
            return None
        kind = pre_tok.get("type")
        if kind == "Sequence":
            for sub in pre_tok.get("pretokenizers", []):
                pattern = BPETokenizer._split_pattern(sub)
                if pattern is not None:
                    return pattern
            return None
        if kind == "Split":
            pattern = pre_tok.get("pattern", {})
            return pattern.get("Regex") or pattern.get("String")
        if kind == "ByteLevel" and pre_tok.get("use_regex", True):
            return _GPT2_PATTERN
        return None

    @classmethod
    def from_file(cls, path: str | Path) -> "BPETokenizer":
        """Load ``tokenizer.json`` (or a directory containing one)."""
        path = Path(path)
        if path.is_dir():
            path = path / "tokenizer.json"
        spec = json.loads(path.read_text())
        model = spec["model"]
        if model.get("type") != "BPE":
            raise ValueError(f"not a BPE tokenizer: {model.get('type')}")
        merges = [
            tuple(m.split(" ", 1)) if isinstance(m, str) else tuple(m)
            for m in model["merges"]
        ]
        added = {
            t["content"]: t["id"] for t in spec.get("added_tokens", [])
        }
        return cls(
            model["vocab"],
            merges,
            added,
            pattern=cls._split_pattern(spec.get("pre_tokenizer")),
            ignore_merges=model.get("ignore_merges", False),
        )

    # -- encode -------------------------------------------------------------

    def _bpe(self, token: str) -> list[str]:
        parts = list(token)
        while len(parts) > 1:
            best_rank = None
            best_i = -1
            for i in range(len(parts) - 1):
                rank = self.ranks.get((parts[i], parts[i + 1]))
                if rank is not None and (best_rank is None or rank < best_rank):
                    best_rank, best_i = rank, i
            if best_rank is None:
                break
            parts[best_i : best_i + 2] = [parts[best_i] + parts[best_i + 1]]
        return parts

    def _encode_text(self, text: str) -> list[int]:
        ids: list[int] = []
        for match in self._pattern.finditer(text):
            word = match.group(0)
            mapped = "".join(self._byte_map[b] for b in word.encode("utf-8"))
            if self.ignore_merges and mapped in self.vocab:
                ids.append(self.vocab[mapped])
                continue
            for part in self._bpe(mapped):
                idx = self.vocab.get(part)
                if idx is None:  # unseen merge result: fall back per char
                    ids.extend(
                        self.vocab[c] for c in part if c in self.vocab
                    )
                else:
                    ids.append(idx)
        return ids

    def encode(self, text: str) -> list[int]:
        """Text → ids, recognizing added special tokens verbatim."""
        if not self.added:
            return self._encode_text(text)
        ids: list[int] = []
        rest = text
        while rest:
            hit, hit_pos = None, len(rest)
            for token in self._added_sorted:
                pos = rest.find(token)
                if 0 <= pos < hit_pos:
                    hit, hit_pos = token, pos
            if hit is None:
                ids.extend(self._encode_text(rest))
                break
            if hit_pos:
                ids.extend(self._encode_text(rest[:hit_pos]))
            ids.append(self.added[hit])
            rest = rest[hit_pos + len(hit) :]
        return ids

    # -- decode -------------------------------------------------------------

    def decode(self, ids, skip_special: bool = True) -> str:
        special_ids = set(self.added.values())
        out: list[str] = []
        buffer: list[int] = []

        def flush():
            if buffer:
                text = "".join(self.inv_vocab.get(i, "") for i in buffer)
                data = bytes(
                    self._byte_unmap[c] for c in text if c in self._byte_unmap
                )
                out.append(data.decode("utf-8", errors="replace"))
                buffer.clear()

        for i in ids:
            i = int(i)
            if i in special_ids:
                flush()
                if not skip_special:
                    out.append(self.inv_vocab[i])
            else:
                buffer.append(i)
        flush()
        return "".join(out)

    def __len__(self) -> int:
        return max(
            len(self.vocab), (max(self.added.values()) + 1) if self.added else 0
        )
