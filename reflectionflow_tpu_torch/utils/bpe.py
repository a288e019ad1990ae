"""Byte-level BPE tokenizers in pure Python: CLIP's and Qwen2's.

The port's machine has neither `transformers` nor `tokenizers` nor `regex`,
and the JAX package reads both vocabularies through transformers'
`AutoTokenizer` (`reflectionflow_tpu/utils/tokenizers.py:46-67`,
`utils/hf_loader.py:182-188`). These classes give the same ids from the same
snapshot files, as `utils/spm.py` does for T5:

  * `CLIPBPETokenizer` (`vocab.json` + `merges.txt`): transformers' fast CLIP
    tokenizer, which `AutoTokenizer` returns: NFC, every whitespace run to one
    space, lower case; the pre-split `'s|'t|'re|'ve|'m|'ll|'d|\\p{L}+|\\p{N}|
    [^\\s\\p{L}\\p{N}]+` (whitespace dropped); byte-level symbols with `</w>` on
    each word's last; bos/eos around, truncation and padding to `max_length`.
  * `Qwen2BPETokenizer` (`tokenizer.json`, or `vocab.json` + `merges.txt` with
    `tokenizer_config.json`): the added tokens (`<|im_start|>`,
    `<|vision_start|>`, `<|image_pad|>` ...) are matched in the raw text first;
    every other piece is NFC-normalised, pre-split by Qwen2's pattern and
    byte-level encoded; `decode` maps the symbols back to bytes.

The regex classes are written out: `\\s` is Unicode's White_Space property
(the set the Rust tokenizer's `\\s` matches), `\\p{L}` / `\\p{N}` are the
`unicodedata` categories L* / N* (Python's Unicode version: characters
assigned only in later versions may classify differently).
"""

from __future__ import annotations

import json
import os
import unicodedata

import numpy as np

_WHITESPACE = frozenset("\t\n\v\f\r \x85\xa0\u1680\u2000\u2001\u2002\u2003\u2004\u2005\u2006"
                        "\u2007\u2008\u2009\u200a\u2028\u2029\u202f\u205f\u3000")


def _is_space(c: str) -> bool:
    return c in _WHITESPACE


def _is_letter(c: str) -> bool:
    return unicodedata.category(c)[0] == "L"


def _is_number(c: str) -> bool:
    return unicodedata.category(c)[0] == "N"


def _is_other(c: str) -> bool:
    return not (_is_space(c) or _is_letter(c) or _is_number(c))


def _run(s: str, i: int, pred) -> int:
    """End of the run of characters from i that satisfy `pred`."""
    while i < len(s) and pred(s[i]):
        i += 1
    return i


def bytes_to_unicode() -> dict[int, str]:
    """GPT-2's reversible byte -> printable character map."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) + \
        list(range(ord("®"), ord("ÿ") + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


_BYTE_ENCODER = bytes_to_unicode()
_BYTE_DECODER = {c: b for b, c in _BYTE_ENCODER.items()}
_CONTRACTIONS = ("s", "t", "re", "ve", "m", "ll", "d")


def _contraction(s: str, i: int, fold: bool) -> int:
    """End of a `'s|'t|'re|'ve|'m|'ll|'d` match at i (case-insensitive with
    `fold`), or -1."""
    if s[i] != "'":
        return -1
    for c in _CONTRACTIONS:
        cand = s[i + 1 : i + 1 + len(c)]
        if fold:  # Unicode simple case folding: only U+017F folds onto one of these letters
            cand = cand.lower().replace("ſ", "s")
        if cand == c:
            return i + 1 + len(c)
    return -1


def clip_pre_split(text: str) -> list[str]:
    """CLIP's pre-split of normalised text; whitespace between matches is dropped."""
    out, i, n = [], 0, len(text)
    while i < n:
        c = text[i]
        if _is_space(c):
            i += 1
            continue
        end = _contraction(text, i, fold=False)
        if end < 0:
            if _is_letter(c):
                end = _run(text, i, _is_letter)
            elif _is_number(c):
                end = i + 1
            else:
                end = _run(text, i, _is_other)
        out.append(text[i:end])
        i = end
    return out


def qwen2_pre_split(text: str) -> list[str]:
    """Qwen2's pre-split, `(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\\r\\n\\p{L}\\p{N}]?\\p{L}+|
    \\p{N}| ?[^\\s\\p{L}\\p{N}]+[\\r\\n]*|\\s*[\\r\\n]+|\\s+(?!\\S)|\\s+`, as the
    alternation matches it: first alternative that matches at each position."""
    out, i, n = [], 0, len(text)
    nl = "\r\n"
    while i < n:
        c = text[i]
        end = _contraction(text, i, fold=True)
        if end < 0 and _is_letter(c):
            end = _run(text, i, _is_letter)
        if end < 0 and c not in nl and not _is_letter(c) and not _is_number(c) \
                and i + 1 < n and _is_letter(text[i + 1]):
            end = _run(text, i + 1, _is_letter)
        if end < 0 and _is_number(c):
            end = i + 1
        if end < 0:
            j = i + 1 if c == " " and i + 1 < n and _is_other(text[i + 1]) else i
            if _is_other(text[j]):
                end = _run(text, _run(text, j, _is_other), lambda x: x in nl)
        if end < 0:  # c is whitespace
            k = _run(text, i, _is_space)
            last_nl = max((p for p in range(i, k) if text[p] in nl), default=-1)
            if last_nl >= 0:
                end = last_nl + 1
            elif k == n or k - 1 == i:
                end = k
            else:
                end = k - 1
        out.append(text[i:end])
        i = end
    return out


class _ByteLevelBPE:
    """Vocabulary, merge ranks and the byte-level BPE of one pre-split word."""

    suffix = ""  # appended to a word's last symbol (CLIP's "</w>")

    def __init__(self, vocab: dict[str, int], merges: list[tuple[str, str]],
                 added: list[dict] | None = None, unk_token: str | None = None):
        self.encoder = dict(vocab)
        self.ranks = {pair: r for r, pair in enumerate(merges)}
        self.added = {t["content"]: t for t in added or []}
        for content, t in self.added.items():
            self.encoder[content] = t["id"]
        self.decoder = {i: t for t, i in self.encoder.items()}
        self.special_ids = {t["id"] for t in self.added.values() if t.get("special", True)}
        self.unk_token = unk_token
        self._cache: dict[str, list[str]] = {}
        # longest added token first, so a prefix never shadows a longer one
        self._added_order = sorted(self.added, key=len, reverse=True)

    def bpe(self, token: str) -> list[str]:
        if token in self._cache:
            return self._cache[token]
        word = list(token[:-1]) + [token[-1] + self.suffix]
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.ranks.get(p, float("inf")))
            if best not in self.ranks:
                break
            merged, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and (word[i], word[i + 1]) == best:
                    merged.append(word[i] + word[i + 1])
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        self._cache[token] = word
        return word

    def _word_ids(self, word: str) -> list[int]:
        symbols = self.bpe("".join(_BYTE_ENCODER[b] for b in word.encode("utf-8")))
        unk = self.encoder.get(self.unk_token) if self.unk_token is not None else None
        ids = []
        for s in symbols:
            i = self.encoder.get(s, unk)
            if i is None:
                raise KeyError(f"symbol {s!r} is not in the vocabulary and there is no unk token")
            ids.append(i)
        return ids

    def _split_added(self, text: str) -> list[tuple[str, bool]]:
        """-> [(piece, is_added_token)], the added tokens matched leftmost-longest."""
        if not self.added:
            return [(text, False)]
        out, start, i = [], 0, 0
        while i < len(text):
            hit = next((t for t in self._added_order if text.startswith(t, i)), None)
            if hit is None:
                i += 1
                continue
            if i > start:
                out.append((text[start:i], False))
            out.append((hit, True))
            i += len(hit)
            start = i
        if start < len(text):
            out.append((text[start:], False))
        return out

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        """ids -> text: each symbol's characters back to bytes (a symbol with a
        character outside the byte map, an added token's text, is taken as
        UTF-8). An id with no symbol (a model's padded vocabulary rows) is
        skipped, as transformers skips it."""
        data = bytearray()
        for i in ids:
            i = int(i)
            if (skip_special_tokens and i in self.special_ids) or i not in self.decoder:
                continue
            tok = self.decoder[i]
            if self.suffix:
                tok = tok.replace(self.suffix, " ")
            try:
                data.extend(_BYTE_DECODER[c] for c in tok)
            except KeyError:
                data.extend(tok.encode("utf-8"))
        return data.decode("utf-8", errors="replace")


def _read_json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _read_merges_txt(path: str) -> list[tuple[str, str]]:
    with open(path, encoding="utf-8") as f:
        lines = f.read().split("\n")
    return [tuple(line.split(" ")) for line in lines if line and not line.startswith("#version")]


class CLIPBPETokenizer(_ByteLevelBPE):
    """CLIP's tokenizer; called as the pipeline calls every text tokenizer:
    `tok(texts, max_length) -> {"input_ids", "attention_mask"}` (int32, padded)."""

    suffix = "</w>"
    # the slow CLIP tokenizer reads at most this many merges (transformers'
    # `merges[1 : 49152 - 256 - 2 + 1]` after the version line)
    max_merges = 49152 - 256 - 2

    def __init__(self, vocab: dict[str, int], merges: list[tuple[str, str]],
                 bos_token: str = "<|startoftext|>", eos_token: str = "<|endoftext|>",
                 pad_token: str = "<|endoftext|>", unk_token: str = "<|endoftext|>"):
        added = [{"content": t, "id": vocab[t], "special": True} for t in dict.fromkeys((bos_token, eos_token))]
        super().__init__(vocab, merges[: self.max_merges], added, unk_token=unk_token)
        self.bos_token_id = vocab[bos_token]
        self.eos_token_id = vocab[eos_token]
        self.pad_token_id = vocab[pad_token]

    @classmethod
    def from_dir(cls, path: str) -> "CLIPBPETokenizer":
        kw = {}
        for name in ("special_tokens_map.json", "tokenizer_config.json"):
            fp = os.path.join(path, name)
            if os.path.exists(fp):
                for key in ("bos_token", "eos_token", "pad_token", "unk_token"):
                    tok = _read_json(fp).get(key)
                    if tok is not None and key not in kw:
                        kw[key] = tok["content"] if isinstance(tok, dict) else tok
        return cls(_read_json(os.path.join(path, "vocab.json")),
                   _read_merges_txt(os.path.join(path, "merges.txt")), **kw)

    @staticmethod
    def normalize(text: str) -> str:
        text = unicodedata.normalize("NFC", text)
        out, i = [], 0
        while i < len(text):
            if _is_space(text[i]):
                i = _run(text, i, _is_space)
                out.append(" ")
            else:
                out.append(text[i])
                i += 1
        return "".join(out).lower()

    def encode(self, text: str, add_special_tokens: bool = True) -> list[int]:
        ids = []
        for piece, is_added in self._split_added(self.normalize(text)):
            if is_added:
                ids.append(self.encoder[piece])
                continue
            for word in clip_pre_split(piece):
                ids.extend(self._word_ids(word))
        return [self.bos_token_id, *ids, self.eos_token_id] if add_special_tokens else ids

    def __call__(self, texts: list[str], max_length: int) -> dict[str, np.ndarray]:
        B = len(texts)
        ids = np.full((B, max_length), self.pad_token_id, dtype=np.int32)
        mask = np.zeros((B, max_length), dtype=np.int32)
        for b, text in enumerate(texts):
            body = self.encode(text, add_special_tokens=False)[: max_length - 2]
            row = [self.bos_token_id, *body, self.eos_token_id]
            ids[b, : len(row)] = row
            mask[b, : len(row)] = 1
        return {"input_ids": ids, "attention_mask": mask}


class Qwen2BPETokenizer(_ByteLevelBPE):
    """Qwen2's byte-level BPE with its added tokens; `encode` / `decode` are the
    two calls the Qwen generator and verifier make."""

    @classmethod
    def from_dir(cls, path: str) -> "Qwen2BPETokenizer":
        tj = os.path.join(path, "tokenizer.json")
        if os.path.exists(tj):
            data = _read_json(tj)
            model = data["model"]
            if model.get("type", "BPE") != "BPE":
                raise ValueError(f"{tj}: a {model.get('type')} model, not BPE")
            merges = [tuple(m.split(" ")) if isinstance(m, str) else tuple(m) for m in model["merges"]]
            added = [{"content": t["content"], "id": t["id"], "special": t.get("special", True)}
                     for t in data.get("added_tokens", [])]
            return cls(model["vocab"], merges, added)
        cfg_path = os.path.join(path, "tokenizer_config.json")
        decoder = _read_json(cfg_path).get("added_tokens_decoder", {}) if os.path.exists(cfg_path) else {}
        added = [{"content": t["content"], "id": int(i), "special": t.get("special", True)}
                 for i, t in decoder.items()]
        return cls(_read_json(os.path.join(path, "vocab.json")),
                   _read_merges_txt(os.path.join(path, "merges.txt")), added)

    def encode(self, text: str, add_special_tokens: bool = False) -> list[int]:
        """Qwen2 adds no bos/eos: `add_special_tokens` changes nothing."""
        ids = []
        for piece, is_added in self._split_added(text):
            if is_added:
                ids.append(self.encoder[piece])
                continue
            for word in qwen2_pre_split(unicodedata.normalize("NFC", piece)):
                ids.extend(self._word_ids(word))
        return ids


def has_qwen2_files(path: str) -> bool:
    return os.path.exists(os.path.join(path, "tokenizer.json")) or (
        os.path.exists(os.path.join(path, "vocab.json")) and os.path.exists(os.path.join(path, "merges.txt")))
