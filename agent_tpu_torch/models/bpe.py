"""GPT-2-style byte-level BPE, the tokenizer of BART and RoBERTa checkpoints
(``vocab.json`` + ``merges.txt``) — counterpart of ``agent_tpu.models.bpe``.

The reference's algorithm (byte-to-unicode remap, pre-tokenization by
GPT-2's pattern, greedy lowest-rank merges), so ids equal the reference's
and ``transformers``' slow GPT-2/BART tokenizer token for token. The
reference pre-tokenizes with the ``regex`` package, whose ``\\p{L}`` and
``\\p{N}`` the stdlib ``re`` lacks and which the card's machine does not
have; :func:`pretokenize` classes each character by
``unicodedata.category`` (``L*`` for ``\\p{L}``, ``N*`` for ``\\p{N}``,
Unicode's White_Space for ``\\s``) and runs the pattern with the stdlib
``re`` over ASCII stand-ins of those classes. The two agree on every character the
interpreter's Unicode database assigns; ``regex`` ships its own, newer
database, so a character assigned only after that version (unassigned,
``Cn``, to ``unicodedata``) can be classed differently.
"""

from __future__ import annotations

import json
import os
import re
import threading
import unicodedata
from collections import OrderedDict
from functools import lru_cache
from typing import Dict, List, Tuple

# GPT-2's pattern, as the reference compiles it with ``regex``:
#   's|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+
# \s of that pattern: Unicode's White_Space property (str.isspace
# adds U+001C-U+001F, which \s does not match).
_WHITESPACE = frozenset(
    "\t\n\x0b\x0c\r \x85\xa0\u1680\u2000\u2001\u2002\u2003\u2004\u2005\u2006"
    "\u2007\u2008\u2009\u200a\u2028\u2029\u202f\u205f\u3000"
)

# Loaded-tokenizer cache: LRU-bounded (a drain cycling vocab_path payloads
# must not grow host memory without bound) and keyed by file mtimes, so an
# edited vocab/merges pair reloads instead of serving stale.
_DIR_CACHE_MAX = 8
_dir_cache: "OrderedDict[tuple, ByteLevelBPE]" = OrderedDict()
_dir_cache_lock = threading.Lock()


# The pattern over a stand-in of the text that has the same length: ASCII
# stays itself (its classes are ASCII's), and every other character becomes
# a representative of its class in the reference's pattern. ``\p{L}`` ->
# "a", ``\p{N}`` -> "0", whitespace -> "\t", the rest -> "!"; U+001C-U+001F,
# which ASCII's ``\s`` would not match either but which are no letters,
# become "!" too. So the stdlib ``re`` in ASCII mode finds the reference's
# pieces at the same offsets, and they are cut from the original text.
_ASCII_PAT = re.compile(
    r"""'s|'t|'re|'ve|'m|'ll|'d| ?[A-Za-z]+| ?[0-9]+| ?[^\sA-Za-z0-9]+|\s+(?!\S)|\s+""",
    re.ASCII)
_stand_in: Dict[int, str] = {c: chr(c) for c in range(128)}
_stand_in.update({c: "!" for c in range(0x1C, 0x20)})
_stand_in_lock = threading.Lock()


def _class_of(c: str) -> str:
    if c in _WHITESPACE:
        return "\t"
    cat = unicodedata.category(c)[0]
    return "a" if cat == "L" else "0" if cat == "N" else "!"


def pretokenize(text: str) -> List[str]:
    """The pieces GPT-2's pattern finds in ``text`` (``findall``), in order:
    the first alternative that matches at each position wins, runs are
    greedy, and a whitespace run followed by a non-space leaves its last
    character to the next piece (``\\s+(?!\\S)``)."""
    new = set(map(ord, text)).difference(_stand_in)
    if new:
        with _stand_in_lock:
            _stand_in.update({c: _class_of(chr(c)) for c in new})
    mapped = text.translate(_stand_in)
    return [text[m.start():m.end()] for m in _ASCII_PAT.finditer(mapped)]


@lru_cache(maxsize=1)
def bytes_to_unicode() -> Dict[int, str]:
    """The GPT-2 reversible byte -> printable-unicode table."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


class ByteLevelBPE:
    """Encoder/decoder over a GPT-2 ``vocab.json`` + ``merges.txt`` pair."""

    def __init__(self, vocab: Dict[str, int], merges: List[Tuple[str, str]]) -> None:
        self.vocab = vocab
        self.inv_vocab = {v: k for k, v in vocab.items()}
        self.ranks = {pair: i for i, pair in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {c: b for b, c in self.byte_encoder.items()}
        self._cache: Dict[str, List[str]] = {}
        self._ids: Dict[str, List[int]] = {}  # pre-tokenized piece -> its ids
        self._cache_lock = threading.Lock()

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    @classmethod
    def from_dir(cls, path: str) -> "ByteLevelBPE":
        """The tokenizer of a vocab directory, cached per (absolute path,
        file mtimes), at most ``_DIR_CACHE_MAX`` of them (LRU), so
        ``map_tokenize`` and the BART path share one instance and its merge
        cache. A ``vocab.json`` that is not a token -> id object raises
        ValueError (the callers' soft-error class)."""
        vocab_path = os.path.join(path, "vocab.json")
        merges_path = os.path.join(path, "merges.txt")
        key = (os.path.abspath(path), os.path.getmtime(vocab_path),
               os.path.getmtime(merges_path))
        with _dir_cache_lock:
            hit = _dir_cache.get(key)
            if hit is not None:
                _dir_cache.move_to_end(key)
                return hit
        with open(vocab_path, encoding="utf-8") as f:
            vocab = json.load(f)
        if not isinstance(vocab, dict):
            raise ValueError(f"vocab.json must hold a token->id object, got "
                             f"{type(vocab).__name__}")
        merges: List[Tuple[str, str]] = []
        with open(merges_path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#version"):
                    continue
                a, _, b = line.partition(" ")
                merges.append((a, b))
        tok = cls(vocab, merges)
        with _dir_cache_lock:
            _dir_cache[key] = tok
            _dir_cache.move_to_end(key)
            while len(_dir_cache) > _DIR_CACHE_MAX:
                _dir_cache.popitem(last=False)
        return tok

    def _bpe(self, token: str) -> List[str]:
        with self._cache_lock:
            hit = self._cache.get(token)
        if hit is not None:
            return hit
        word = list(token)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.ranks.get(p, float("inf")))
            if best not in self.ranks:
                break
            first, second = best
            merged: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        with self._cache_lock:
            if len(self._cache) < 65536:  # bound drain-scale memory
                self._cache[token] = word
        return word

    def encode(self, text: str) -> List[int]:
        """Token ids; a piece missing from the vocab raises KeyError (an
        inconsistent vocab/merges pair)."""
        ids: List[int] = []
        for piece in pretokenize(text):
            hit = self._ids.get(piece)
            if hit is None:
                mapped = "".join(self.byte_encoder[b] for b in piece.encode("utf-8"))
                hit = [self.vocab[p] for p in self._bpe(mapped)]
                with self._cache_lock:
                    if len(self._ids) < 65536:  # bound drain-scale memory
                        self._ids[piece] = hit
            ids.extend(hit)
        return ids

    def decode(self, ids) -> str:
        text = "".join(self.inv_vocab.get(int(i), "") for i in ids)
        raw = bytes(self.byte_decoder[c] for c in text if c in self.byte_decoder)
        return raw.decode("utf-8", errors="replace")
