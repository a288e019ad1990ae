"""Pure-Python SentencePiece unigram tokenizer (no `sentencepiece` dep).

Copy of `reflectionflow_tpu/utils/spm.py`, which the reference exposes only
through a jax-importing `utils/__init__.py`.

The deployment image has no sentencepiece wheel, but T5 tokenization needs
the FLUX snapshot's `spiece.model`. That file is a protobuf
(sentencepiece.ModelProto); the wire format is simple enough to parse by
hand: field 1 = repeated SentencePiece{1: piece (string), 2: score (float),
3: type (enum)}. Encoding is standard unigram Viterbi over the
whitespace-escaped text with byte-fallback for unknown characters.

Verified against T5TokenizerFast outputs where a tokenizer.json is present.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

NORMAL = 1
UNKNOWN = 2
CONTROL = 3
USER_DEFINED = 4
BYTE = 6

SPACE = "▁"  # ▁


def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7


def parse_model_proto(data: bytes) -> list[tuple[str, float, int]]:
    """-> [(piece, score, type)] in vocab-id order."""
    pieces = []
    i = 0
    n = len(data)
    while i < n:
        tag, i = _read_varint(data, i)
        field, wire = tag >> 3, tag & 7
        if field == 1 and wire == 2:  # repeated SentencePiece
            length, i = _read_varint(data, i)
            sub = data[i : i + length]
            i += length
            piece, score, ptype = "", 0.0, NORMAL
            j = 0
            while j < len(sub):
                stag, j = _read_varint(sub, j)
                sfield, swire = stag >> 3, stag & 7
                if sfield == 1 and swire == 2:
                    slen, j = _read_varint(sub, j)
                    piece = sub[j : j + slen].decode("utf-8", "replace")
                    j += slen
                elif sfield == 2 and swire == 5:
                    (score,) = struct.unpack("<f", sub[j : j + 4])
                    j += 4
                elif sfield == 3 and swire == 0:
                    ptype, j = _read_varint(sub, j)
                else:  # skip unknown subfield
                    if swire == 0:
                        _, j = _read_varint(sub, j)
                    elif swire == 2:
                        slen, j = _read_varint(sub, j)
                        j += slen
                    elif swire == 5:
                        j += 4
                    elif swire == 1:
                        j += 8
                    else:
                        raise ValueError(f"bad wire type {swire}")
            pieces.append((piece, score, ptype))
        else:  # skip other top-level fields (trainer/normalizer specs)
            if wire == 0:
                _, i = _read_varint(data, i)
            elif wire == 2:
                length, i = _read_varint(data, i)
                i += length
            elif wire == 5:
                i += 4
            elif wire == 1:
                i += 8
            else:
                raise ValueError(f"bad wire type {wire}")
    return pieces


@dataclass
class UnigramTokenizer:
    vocab: dict[str, int]
    scores: list[float]
    pieces: list[str]
    unk_id: int
    byte_ids: dict[int, int]  # byte value -> piece id (byte fallback)
    max_piece_len: int

    @classmethod
    def from_file(cls, path: str) -> "UnigramTokenizer":
        with open(path, "rb") as f:
            entries = parse_model_proto(f.read())
        vocab: dict[str, int] = {}
        scores: list[float] = []
        pieces: list[str] = []
        unk_id = 0
        byte_ids: dict[int, int] = {}
        for idx, (piece, score, ptype) in enumerate(entries):
            # only NORMAL / USER_DEFINED pieces participate in matching —
            # control/unknown/byte pieces must not be reachable from literal
            # text (sentencepiece convention)
            if ptype in (NORMAL, USER_DEFINED):
                vocab[piece] = idx
            scores.append(score)
            pieces.append(piece)
            if ptype == UNKNOWN:
                unk_id = idx
            if ptype == BYTE and piece.startswith("<0x"):
                byte_ids[int(piece[3:5], 16)] = idx
        max_len = max((len(p) for p in pieces), default=1)
        return cls(vocab, scores, pieces, unk_id, byte_ids, max_len)

    def normalize(self, text: str) -> str:
        """NMT-NFKC-style normalization (sentencepiece T5 default): NFKC,
        control whitespace -> space, collapse runs, strip."""
        import re
        import unicodedata

        text = unicodedata.normalize("NFKC", text)
        text = re.sub(r"[\t\n\r\v\f\u200b\ufeff]", " ", text)
        text = re.sub(r" {2,}", " ", text).strip()
        return text

    def encode_text(self, text: str) -> list[int]:
        """Unigram Viterbi segmentation (T5 convention: spaces -> ▁, leading ▁)."""
        text = self.normalize(text)
        text = SPACE + text.replace(" ", SPACE)
        n = len(text)
        NEG = -1e18
        best = [NEG] * (n + 1)
        back: list[tuple[int, int] | None] = [None] * (n + 1)
        best[0] = 0.0
        unk_penalty = min(self.scores) - 10.0 if self.scores else -20.0
        for i in range(n):
            if best[i] == NEG:
                continue
            limit = min(self.max_piece_len, n - i)
            matched = False
            for L in range(1, limit + 1):
                piece = text[i : i + L]
                pid = self.vocab.get(piece)
                if pid is None:
                    continue
                matched = True
                s = best[i] + self.scores[pid]
                if s > best[i + L]:
                    best[i + L] = s
                    back[i + L] = (i, pid)
            if not matched or best[i + 1] == NEG:
                # unknown single char (byte-fallback happens at decode of ids)
                s = best[i] + unk_penalty
                if s > best[i + 1]:
                    best[i + 1] = s
                    back[i + 1] = (i, -1)  # marker: raw char
        # walk back
        out_rev: list[int] = []
        pos = n
        while pos > 0:
            prev, pid = back[pos]
            if pid == -1:
                ch = text[prev:pos]
                bts = ch.encode("utf-8")
                ids = [self.byte_ids.get(b, self.unk_id) for b in bts] if self.byte_ids else [self.unk_id]
                out_rev.extend(reversed(ids))
            else:
                out_rev.append(pid)
            pos = prev
        return list(reversed(out_rev))


class SPMTokenizer:
    """Drop-in for utils.tokenizers: T5-style batch encoding with EOS + pad."""

    def __init__(self, model_path: str, eos_token_id: int = 1, pad_token_id: int = 0):
        self.tok = UnigramTokenizer.from_file(model_path)
        self.eos_token_id = eos_token_id
        self.pad_token_id = pad_token_id

    def __call__(self, texts: list[str], max_length: int):
        import numpy as np

        B = len(texts)
        ids = np.full((B, max_length), self.pad_token_id, dtype=np.int32)
        mask = np.zeros((B, max_length), dtype=np.int32)
        for b, text in enumerate(texts):
            toks = self.tok.encode_text(text)[: max_length - 1] + [self.eos_token_id]
            ids[b, : len(toks)] = toks
            mask[b, : len(toks)] = 1
        return {"input_ids": ids, "attention_mask": mask}
