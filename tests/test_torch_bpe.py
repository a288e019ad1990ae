"""The port's pure-Python BPE tokenizers (`reflectionflow_tpu_torch/utils/bpe.py`)
against transformers on tiny vocabularies this file trains: CLIP against
`CLIPTokenizerFast` (what the JAX package's `AutoTokenizer` returns) and the
slow `CLIPTokenizer`, Qwen2 against `Qwen2TokenizerFast` with Qwen's added
tokens. Ids equal on fixed strings and on hypothesis strings (letters of
several scripts, digits, punctuation, whitespace, newlines, the special
tokens); Qwen's `decode(encode(s)) == s`. About 10 s on one core."""

import json
import os
import unicodedata

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from reflectionflow_tpu_torch.utils import bpe

torch.set_num_threads(1)

CORPUS = [
    "a photo of a cat sitting on a red chair, in the style of an oil painting",
    "Two dogs and three birds; the dog's ball isn't there. They'll re-do it.",
    "Ein Hund läuft über die Straße. Το σκυλί τρέχει. Собака бежит по улице.",
    "日本語のテキストと中文文本 1234567890 café naïve résumé",
    "Rate the quality of the image for the prompt:\n\n  indented   spaces\t\ttabs\r\n",
    "<|im_start|>system\nYou are a helpful assistant.<|im_end|>\n",
] * 4
QWEN_SPECIALS = ["<|endoftext|>", "<|im_start|>", "<|im_end|>", "<|vision_start|>", "<|vision_end|>",
                 "<|vision_pad|>", "<|image_pad|>", "<|video_pad|>"]
FIXED = [
    "", " ", "a red cube", "A RED Cube!!", "it's   they're we've I'M you'll he'd",
    "Hello,\n\nworld \r\n  x", "tab\tsep  \t end  ", "  leading and trailing  ",
    "digits 2024-10-17 3.14159", "über naïve café ЖЁЛТЫЙ Ελλάδα", "日本語 テキスト",
    "a<|im_end|>b", "<|im_start|>user\nHi<|im_end|>\n<|im_start|>assistant\n",
    "emoji 🙂🙂 ok", "x's y'S z'LL", "''s ’s", "ſtrange 'ſ",
]
TEXT = st.lists(st.one_of(
    st.characters(min_codepoint=0x20, max_codepoint=0x7E),
    st.sampled_from(list("äöüßéèçñ ÆØÅæøå αβγδΩ жзийЖЗ 日本語中文 ١٢٣ \n\r\t'’ſ")),
    st.sampled_from(QWEN_SPECIALS + ["<|startoftext|>"])), max_size=40).map("".join)
HYP = settings(max_examples=150, deadline=None, suppress_health_check=[HealthCheck.too_slow])


def _train(suffix: str, pattern: str, vocab_size: int):
    from tokenizers import Regex, Tokenizer, models, pre_tokenizers, trainers

    eow = {"end_of_word_suffix": suffix} if suffix else {}
    tok = Tokenizer(models.BPE(**eow))
    split = pre_tokenizers.Split(Regex(pattern), behavior="isolated")
    tok.pre_tokenizer = pre_tokenizers.Sequence(
        [split, pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    trainer = trainers.BpeTrainer(vocab_size=vocab_size, initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
                                  show_progress=False, **eow)
    tok.train_from_iterator([t.lower() if suffix else t for t in CORPUS], trainer)
    merges = json.loads(tok.to_str())["model"]["merges"]
    return [tuple(m.split(" ")) if isinstance(m, str) else tuple(m) for m in merges]


def _write(path, vocab, merges):
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "vocab.json"), "w", encoding="utf-8") as f:
        json.dump(vocab, f, ensure_ascii=False)
    with open(os.path.join(path, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n" + "\n".join(" ".join(m) for m in merges) + "\n")


@pytest.fixture(scope="module")
def clip_pair(tmp_path_factory):
    from transformers import CLIPTokenizer, CLIPTokenizerFast

    merges = _train("</w>", r"'s|'t|'re|'ve|'m|'ll|'d|\p{L}+|\p{N}|[^\s\p{L}\p{N}]+", 500)
    chars = list(bpe.bytes_to_unicode().values())
    tokens = chars + [c + "</w>" for c in chars] + ["".join(m) for m in merges]
    vocab = {t: i for i, t in enumerate(dict.fromkeys(tokens))}
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    path = str(tmp_path_factory.mktemp("clip_tok"))
    _write(path, vocab, merges)
    kw = dict(vocab_file=os.path.join(path, "vocab.json"), merges_file=os.path.join(path, "merges.txt"))
    return (bpe.CLIPBPETokenizer.from_dir(path), CLIPTokenizerFast(**kw), CLIPTokenizer(**kw))


@pytest.fixture(scope="module")
def qwen_pair(tmp_path_factory):
    from transformers import Qwen2TokenizerFast

    pat = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n]*|"
           r"\s*[\r\n]+|\s+(?!\S)|\s+")
    merges = _train("", pat, 600)
    chars = list(bpe.bytes_to_unicode().values())
    vocab = {t: i for i, t in enumerate(dict.fromkeys(chars + ["".join(m) for m in merges]))}
    src = str(tmp_path_factory.mktemp("qwen_src"))
    _write(src, vocab, merges)
    ref = Qwen2TokenizerFast(vocab_file=os.path.join(src, "vocab.json"),
                             merges_file=os.path.join(src, "merges.txt"))
    ref.add_special_tokens({"additional_special_tokens": QWEN_SPECIALS[1:]})
    ref.add_tokens(["<tool_call>"])  # an added token that is not special
    out = str(tmp_path_factory.mktemp("qwen_tok"))
    ref.save_pretrained(out)
    return bpe.Qwen2BPETokenizer.from_dir(out), ref, out


def _clip_ids(ref, text):
    return ref(text)["input_ids"]


@pytest.mark.parametrize("text", FIXED)
def test_clip_ids_match_transformers_fixed(clip_pair, text):
    port, fast, slow = clip_pair
    assert port.encode(text) == _clip_ids(fast, text)
    if text.isascii():  # the slow tokenizer pads CJK and drops control characters; fast does not
        assert port.encode(text) == _clip_ids(slow, text)


@HYP
@given(text=TEXT)
def test_clip_ids_match_transformers_hypothesis(clip_pair, text):
    port, fast, _ = clip_pair
    assert port.encode(text) == _clip_ids(fast, text)


def test_clip_call_pads_and_truncates_as_the_pipeline_asks(clip_pair):
    port, fast, _ = clip_pair
    texts = ["a red cube", "word " * 40, ""]
    got = port(texts, max_length=16)
    want = fast(texts, padding="max_length", max_length=16, truncation=True, return_tensors="np")
    np.testing.assert_array_equal(got["input_ids"], want["input_ids"])
    np.testing.assert_array_equal(got["attention_mask"], want["attention_mask"])
    assert got["input_ids"].dtype == np.int32


@pytest.mark.parametrize("text", FIXED)
def test_qwen_ids_match_transformers_fixed(qwen_pair, text):
    port, ref, _ = qwen_pair
    ids = port.encode(text, add_special_tokens=False)
    assert ids == ref.encode(text, add_special_tokens=False)
    assert port.decode(ids, skip_special_tokens=False) == text
    assert port.decode(ids, skip_special_tokens=True) == ref.decode(ids, skip_special_tokens=True)


@HYP
@given(text=TEXT)
def test_qwen_ids_match_transformers_hypothesis(qwen_pair, text):
    port, ref, _ = qwen_pair
    ids = port.encode(text)
    assert ids == ref.encode(text, add_special_tokens=False)
    assert port.decode(ids, skip_special_tokens=False) == unicodedata.normalize("NFC", text)
    assert port.decode(ids, skip_special_tokens=True) == ref.decode(ids, skip_special_tokens=True)


def test_qwen_vocab_merges_layout_and_specials(qwen_pair):
    port, ref, path = qwen_pair
    text = "<|im_start|>user\n<|vision_start|><|image_pad|><|vision_end|>it's <tool_call> 42<|im_end|>\n"
    # the same tokenizer from vocab.json + merges.txt + tokenizer_config.json (no tokenizer.json)
    cfg = json.load(open(os.path.join(path, "tokenizer_config.json")))
    alt = str(os.path.join(path, "no_json"))
    os.makedirs(alt)
    for name in ("vocab.json", "merges.txt"):
        with open(os.path.join(path, name), encoding="utf-8") as src, \
                open(os.path.join(alt, name), "w", encoding="utf-8") as dst:
            dst.write(src.read())
    with open(os.path.join(alt, "tokenizer_config.json"), "w") as f:
        json.dump({"added_tokens_decoder": cfg["added_tokens_decoder"]}, f)
    port2 = bpe.Qwen2BPETokenizer.from_dir(alt)
    want = ref.encode(text, add_special_tokens=False)
    assert port.encode(text) == port2.encode(text) == want
    assert port.decode(want) == ref.decode(want, skip_special_tokens=True)
    assert "<tool_call>" in port.decode(want)  # not special: kept by skip_special_tokens
    assert bpe.has_qwen2_files(path) and bpe.has_qwen2_files(alt)


@pytest.mark.parametrize("text", ["a  b", "a \n b", "x\n\n\ny", "  \t\n ", "a!? b", " !x", "\r\n\r\n z", "ab 12c"])
def test_qwen2_pre_split_matches_the_rust_pattern(text):
    from tokenizers import Regex, pre_tokenizers

    pat = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n]*|"
           r"\s*[\r\n]+|\s+(?!\S)|\s+")
    want = [p for p, _ in pre_tokenizers.Split(Regex(pat), behavior="isolated").pre_tokenize_str(text)]
    assert bpe.qwen2_pre_split(text) == want
