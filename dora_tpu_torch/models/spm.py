"""Minimal SentencePiece-model reader and unigram segmenter (no deps): the
port's own copy of dora_tpu/models/spm.py, pure Python.

Marian/Opus-MT checkpoints ship ``source.spm``/``target.spm`` files — a
serialized ``sentencepiece.ModelProto``. The sentencepiece library is
not a dependency, so this module parses the protobuf directly
(only the piece table is needed) and implements the unigram Viterbi
segmentation sentencepiece uses at inference time: the segmentation of
maximal total piece log-probability, with per-character unknown fallback
at a configurable penalty.

Reference parity: node-hub/dora-opus/dora_opus/main.py drives
transformers' MarianTokenizer, which defers to sentencepiece for exactly
this step (ids then come from vocab.json, see models/hf/marian).
"""

from __future__ import annotations

import struct
from pathlib import Path

WORD_BOUNDARY = "▁"  # "▁"

# sentencepiece ModelProto.SentencePiece.Type values
TYPE_NORMAL = 1
TYPE_UNKNOWN = 2
TYPE_CONTROL = 3
TYPE_USER_DEFINED = 4
TYPE_UNUSED = 5
TYPE_BYTE = 6

#: score assigned to a single-character unknown fallback, relative to the
#: lowest real piece score (sentencepiece: unk_penalty = min_score - 10).
UNK_PENALTY = 10.0


def _read_varint(buf: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _skip_field(buf: bytes, pos: int, wire_type: int) -> int:
    if wire_type == 0:  # varint
        _, pos = _read_varint(buf, pos)
    elif wire_type == 1:  # 64-bit
        pos += 8
    elif wire_type == 2:  # length-delimited
        n, pos = _read_varint(buf, pos)
        pos += n
    elif wire_type == 5:  # 32-bit
        pos += 4
    else:
        raise ValueError(f"unsupported protobuf wire type {wire_type}")
    return pos


def _parse_piece(buf: bytes) -> tuple[str, float, int]:
    piece, score, kind = "", 0.0, TYPE_NORMAL
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:  # piece
            n, pos = _read_varint(buf, pos)
            piece = buf[pos:pos + n].decode("utf-8")
            pos += n
        elif field == 2 and wire == 5:  # score (float)
            (score,) = struct.unpack_from("<f", buf, pos)
            pos += 4
        elif field == 3 and wire == 0:  # type
            kind, pos = _read_varint(buf, pos)
        else:
            pos = _skip_field(buf, pos, wire)
    return piece, score, kind


def parse_model(path: str | Path) -> list[tuple[str, float, int]]:
    """The (piece, score, type) table of a .spm file, in id order."""
    buf = Path(path).read_bytes()
    pieces: list[tuple[str, float, int]] = []
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:  # repeated SentencePiece
            n, pos = _read_varint(buf, pos)
            pieces.append(_parse_piece(buf[pos:pos + n]))
            pos += n
        else:
            pos = _skip_field(buf, pos, wire)
    return pieces


class SentencePieceModel:
    """Unigram segmentation over a parsed piece table."""

    def __init__(self, pieces: list[tuple[str, float, int]]):
        self.pieces = pieces
        self.scores: dict[str, float] = {}
        self.max_len = 1
        for piece, score, kind in pieces:
            if kind in (TYPE_NORMAL, TYPE_USER_DEFINED):
                self.scores[piece] = score
                self.max_len = max(self.max_len, len(piece))
        min_score = min(self.scores.values(), default=0.0)
        self.unk_score = min_score - UNK_PENALTY

    @classmethod
    def load(cls, path: str | Path) -> "SentencePieceModel":
        return cls(parse_model(path))

    def encode(self, text: str) -> list[str]:
        """Text → pieces: dummy-prefix + space→▁ normalization, then
        Viterbi (ties break toward longer leading pieces, matching
        sentencepiece's left-to-right backtrace)."""
        if not text:
            return []
        s = WORD_BOUNDARY + text.replace(" ", WORD_BOUNDARY)
        n = len(s)
        best = [float("-inf")] * (n + 1)
        back: list[int] = [0] * (n + 1)
        best[0] = 0.0
        for i in range(n):
            if best[i] == float("-inf"):
                continue
            upper = min(n, i + self.max_len)
            matched = False
            for j in range(i + 1, upper + 1):
                piece = s[i:j]
                score = self.scores.get(piece)
                if score is None:
                    continue
                matched = True
                cand = best[i] + score
                if cand > best[j]:
                    best[j] = cand
                    back[j] = i
            if not matched or s[i:i + 1] not in self.scores:
                # Per-character unknown fallback keeps the lattice connected.
                cand = best[i] + self.unk_score
                if cand > best[i + 1]:
                    best[i + 1] = cand
                    back[i + 1] = i
        out: list[str] = []
        j = n
        while j > 0:
            i = back[j]
            out.append(s[i:j])
            j = i
        out.reverse()
        return out

    def decode(self, pieces: list[str]) -> str:
        return "".join(pieces).replace(WORD_BOUNDARY, " ").strip()


def build_model_proto(pieces: list[tuple[str, float, int]]) -> bytes:
    """Serialize a piece table back into ModelProto bytes (test fixture
    support: fabricate tiny .spm files without the sentencepiece lib)."""

    def varint(v: int) -> bytes:
        out = bytearray()
        while True:
            b = v & 0x7F
            v >>= 7
            if v:
                out.append(b | 0x80)
            else:
                out.append(b)
                return bytes(out)

    blob = bytearray()
    for piece, score, kind in pieces:
        body = bytearray()
        raw = piece.encode("utf-8")
        body += b"\x0a" + varint(len(raw)) + raw          # field 1, string
        body += b"\x15" + struct.pack("<f", score)         # field 2, float
        body += b"\x18" + varint(kind)                     # field 3, enum
        blob += b"\x0a" + varint(len(body)) + bytes(body)  # repeated field 1
    return bytes(blob)
