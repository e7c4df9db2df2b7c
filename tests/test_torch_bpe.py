"""The port's byte-level BPE (``agent_tpu_torch.models.bpe``) against the
reference's (``agent_tpu.models.bpe``, which pre-tokenizes with the
``regex`` package): pre-tokenization and ids exactly equal, on non-Latin
letters, non-ASCII digits (where ``\\d``/``\\w`` and ``\\p{N}``/``\\p{L}``
differ), combining marks, emoji and every whitespace of the pattern; the
character classes equal on every character Python's Unicode database
assigns; decode round trips; ``map_tokenize`` with ``tokenizer: "bpe"``
through both registries."""

import json
import random
import unicodedata

import pytest

import chip_smoke
from agent_tpu.models import bpe as jax_bpe
from agent_tpu.ops import get_op as jax_get_op
from agent_tpu_torch.models import bpe
from agent_tpu_torch.ops import load_ops

CORPUS = [
    "Hello world",
    "It's they're we've I'm you'll he'd don't",
    "'S 'T 'RE upper-case contractions stay pieces",
    "Arabic-Indic digits ٣٤٥ and superscripts x² y³",
    "Roman numerals Ⅻ Ⅷ, fractions ½ ¼ ¾",
    "combining: é ạ̀ ñ and a lone ́ mark",
    "emoji 😀🎉 👩‍💻 flags 🇫🇷",
    "中文字符 日本語のテキスト 한국어",
    "Ελληνικά русский עברית العربية",
    "tabs\tand\nnewlines\r\nand  double  spaces   trailing   ",
    "no-break\xa0space, ideographic　space, em space",
    "file separators \x1c\x1d\x1e\x1f are not whitespace",
    "numbers 3.14159 1,000,000 and 2024-01-01",
    "punctuation!!! ??? ... --- ___ $$$ @#%^&*()",
    "  leading spaces and a single trailing space ",
    "",
    " ",
    "'",
    "''s ''",
    "mixed٣abc²def½",
]


@pytest.fixture(scope="module")
def vocab_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("bpe")
    chip_smoke.write_bpe_vocab(str(d), 800, 11)
    return str(d)


@pytest.mark.parametrize("i", range(len(CORPUS)))
def test_pretokenize_equals_the_reference(i):
    assert bpe.pretokenize(CORPUS[i]) == jax_bpe._PAT.findall(CORPUS[i])


@pytest.mark.parametrize("i", range(len(CORPUS)))
def test_ids_equal_the_reference(vocab_dir, i):
    got = bpe.ByteLevelBPE.from_dir(vocab_dir).encode(CORPUS[i])
    want = jax_bpe.ByteLevelBPE.from_dir(vocab_dir).encode(CORPUS[i])
    assert got == want


@pytest.mark.parametrize("i", range(len(CORPUS)))
def test_decode_round_trips(vocab_dir, i):
    tok = bpe.ByteLevelBPE.from_dir(vocab_dir)
    ids = tok.encode(CORPUS[i])
    assert tok.decode(ids) == CORPUS[i]
    assert tok.decode(ids) == jax_bpe.ByteLevelBPE.from_dir(vocab_dir).decode(ids)


def test_character_classes_equal_regex_on_every_assigned_character():
    """\\p{L}, \\p{N} and \\s as the reference's ``regex`` classes them, for
    every code point Python's Unicode database assigns (the ``regex``
    package carries a newer database; characters unassigned to Python's
    can be classed differently)."""
    import regex

    chars = "".join(chr(c) for c in range(0x110000)
                    if not 0xD800 <= c <= 0xDFFF and unicodedata.category(chr(c)) != "Cn")
    for name, pattern, cls in (("letter", r"\p{L}", "a"), ("number", r"\p{N}", "0"),
                               ("space", r"\s", "\t")):
        want = set(regex.findall(pattern, chars))
        got = {c for c in chars if ord(c) >= 128 and bpe._class_of(c) == cls}
        assert got == {c for c in want if ord(c) >= 128}, name


@pytest.mark.parametrize("seed", range(4))
def test_random_strings_pretokenize_as_the_reference(seed):
    rng = random.Random(seed)
    alphabet = list("ab Z' \t\n\x0b\x85.,!?09٣²Ⅻ½é́😀中\xa0 \x1csdtremvlS-_") \
        + ["'s", "'ll", "'re", "'d", "  ", "\t ", "'S"]
    for _ in range(500):
        text = "".join(rng.choice(alphabet) for _ in range(rng.randint(0, 40)))
        assert bpe.pretokenize(text) == jax_bpe._PAT.findall(text), repr(text)


def test_from_dir_caches_and_reloads_an_edited_vocab(vocab_dir, tmp_path):
    assert bpe.ByteLevelBPE.from_dir(vocab_dir) is bpe.ByteLevelBPE.from_dir(vocab_dir)
    (tmp_path / "vocab.json").write_text(json.dumps({"a": 0}))
    (tmp_path / "merges.txt").write_text("#version: 0.2\n")
    first = bpe.ByteLevelBPE.from_dir(str(tmp_path))
    (tmp_path / "vocab.json").write_text(json.dumps({"a": 0, "b": 1}))
    import os

    os.utime(tmp_path / "vocab.json", (1e9, 1e9))
    second = bpe.ByteLevelBPE.from_dir(str(tmp_path))
    assert second is not first and second.vocab_size == 2


def test_a_vocab_that_is_no_object_raises_as_the_reference(tmp_path):
    (tmp_path / "vocab.json").write_text("[1, 2]")
    (tmp_path / "merges.txt").write_text("")
    with pytest.raises(ValueError) as got:
        bpe.ByteLevelBPE.from_dir(str(tmp_path))
    with pytest.raises(ValueError) as want:
        jax_bpe.ByteLevelBPE.from_dir(str(tmp_path))
    assert str(got.value) == str(want.value)


TOKENIZE_CASES = [
    {"text": "Hello wörld ٣²Ⅻ½ 😀", "tokenizer": "bpe", "vocab_path": "VOCAB"},
    {"items": CORPUS, "tokenizer": "bpe", "vocab_path": "VOCAB", "chunk_size": 7},
    {"items": ["a", ""], "tokenizer": "bpe", "vocab_path": "VOCAB"},
    {"text": "x", "tokenizer": "bpe", "vocab_path": "/nonexistent/dir"},
    {"text": "x", "tokenizer": "bpe"},
    {"text": "zzz", "tokenizer": "bpe", "vocab_path": "INCONSISTENT"},
]


@pytest.mark.parametrize("i", range(len(TOKENIZE_CASES)))
def test_map_tokenize_bpe_matches_the_reference(vocab_dir, tmp_path, i):
    bad = tmp_path / "inconsistent"
    bad.mkdir()
    (bad / "vocab.json").write_text(json.dumps({"z": 0}))
    (bad / "merges.txt").write_text("z z\n")
    payload = json.loads(json.dumps(TOKENIZE_CASES[i]).replace("VOCAB", vocab_dir)
                         .replace("INCONSISTENT", str(bad)))
    got = load_ops(["map_tokenize"])["map_tokenize"](dict(payload))
    want = jax_get_op("map_tokenize")(dict(payload))
    assert got == want
