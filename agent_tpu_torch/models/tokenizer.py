"""Tokenization and bucketed padding for the classify and summarize paths
and ``map_tokenize``.

A copy of the part of ``agent_tpu.models.tokenizer`` that the ported ops
use: the byte vocabulary's specials, ``ByteTokenizer``, the wordpiece
tokenizer over a local vocab file (loading and encoding), the length
buckets, the fused byte-tokenize-and-pad (``byte_encode_pad``, with BOS/EOS
and its ``raw_uint8`` wire), ``pad_batch`` for pre-tokenized ids and the
``get_tokenizer`` factory, whose ``bpe`` kind is :mod:`agent_tpu_torch.models.bpe`.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

PAD_ID = 0
BOS_ID = 1
EOS_ID = 2
UNK_ID = 3
N_SPECIAL = 4  # <pad>, <bos>, <eos>, <unk>; byte b has id b + N_SPECIAL
SPECIAL_TOKENS = ("<pad>", "<bos>", "<eos>", "<unk>")

# Powers of two and their midpoints, so a row pads by at most ~1.5x.
DEFAULT_BUCKETS = (
    16, 32, 48, 64, 96, 128, 192, 256, 384, 512, 768, 1024, 1536, 2048,
    3072, 4096,
)


class ByteTokenizer:
    """UTF-8 byte-level tokenizer: id = byte + N_SPECIAL. Vocab size 260."""

    vocab_size = 256 + N_SPECIAL
    pad_id, bos_id, eos_id, unk_id = PAD_ID, BOS_ID, EOS_ID, UNK_ID

    def encode(self, text: str, add_bos: bool = False, add_eos: bool = False) -> List[int]:
        ids = [b + N_SPECIAL for b in text.encode("utf-8")]
        if add_bos:
            ids.insert(0, BOS_ID)
        if add_eos:
            ids.append(EOS_ID)
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        raw = bytes(i - N_SPECIAL for i in ids if i >= N_SPECIAL)
        return raw.decode("utf-8", errors="replace")


_WORD_RE = re.compile(r"\w+|[^\w\s]", re.UNICODE)


class WordPieceTokenizer:
    """Greedy longest-match wordpiece (BERT-style ``##`` continuations) over
    a vocab file: one token per line, id = line number."""

    pad_id, bos_id, eos_id, unk_id = PAD_ID, BOS_ID, EOS_ID, UNK_ID

    def __init__(self, vocab: Dict[str, int], lowercase: bool = True,
                 max_word_chars: int = 64) -> None:
        self.vocab = vocab
        self.lowercase = lowercase
        self.max_word_chars = max_word_chars

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    @classmethod
    def from_file(cls, path: str, lowercase: bool = True) -> "WordPieceTokenizer":
        vocab: Dict[str, int] = {}
        with open(path, "r", encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        return cls(vocab=vocab, lowercase=lowercase)

    def _encode_word(self, word: str) -> List[int]:
        if len(word) > self.max_word_chars:
            return [self.unk_id]
        ids: List[int] = []
        start = 0
        while start < len(word):
            end = len(word)
            piece_id = None
            while end > start:
                piece = word[start:end]
                if start > 0:
                    piece = "##" + piece
                pid = self.vocab.get(piece)
                if pid is not None:
                    piece_id = pid
                    break
                end -= 1
            if piece_id is None:
                return [self.unk_id]
            ids.append(piece_id)
            start = end
        return ids

    def encode(self, text: str, add_bos: bool = False, add_eos: bool = False) -> List[int]:
        if self.lowercase:
            text = text.lower()
        ids: List[int] = []
        if add_bos:
            ids.append(self.bos_id)
        for w in _WORD_RE.findall(text):
            ids.extend(self._encode_word(w))
        if add_eos:
            ids.append(self.eos_id)
        return ids


def get_tokenizer(kind: str = "byte", vocab_path: Optional[str] = None):
    """``byte`` (default), ``wordpiece`` (needs a vocab.txt path) or ``bpe``
    (GPT-2/BART byte-level BPE; needs a directory holding vocab.json +
    merges.txt, e.g. an HF checkpoint directory). ValueError for a bad kind
    or a missing path; OSError when the vocab does not open."""
    if kind == "byte":
        return ByteTokenizer()
    if kind == "wordpiece":
        if vocab_path:
            return WordPieceTokenizer.from_file(vocab_path)
        raise ValueError("wordpiece tokenizer requires vocab_path")
    if kind == "bpe":
        if vocab_path:
            from agent_tpu_torch.models.bpe import ByteLevelBPE

            return ByteLevelBPE.from_dir(vocab_path)
        raise ValueError(
            "bpe tokenizer requires vocab_path (dir with vocab.json + merges.txt)"
        )
    raise ValueError(f"unknown tokenizer kind {kind!r}")


def bucket_length(n: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    """Smallest bucket >= n (or the largest bucket — callers truncate to it)."""
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def byte_encode_pad(
    texts: Sequence[str],
    buckets: Sequence[int] = DEFAULT_BUCKETS,
    batch_buckets: Optional[Sequence[int]] = None,
    max_len_cap: Optional[int] = None,
    add_bos: bool = False,
    add_eos: bool = False,
    raw_uint8: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Fused byte-tokenize + pad: texts -> (ids[B, L], lengths[B] int32).

    ids are ``byte + N_SPECIAL`` as int32, with BOS/EOS when asked (they
    count toward the cap, exactly like ``encode(add_bos, add_eos)[:cap]``:
    a too-long text loses its EOS), or with ``raw_uint8=True`` the unshifted
    bytes as uint8: the device rebuilds ``(raw + N_SPECIAL) * mask``, which
    is exact because the mask tells a body NUL byte (raw 0, masked in) from
    padding (raw 0, masked out); that wire carries no BOS/EOS. Rows longer
    than the cap (or the top bucket) are truncated; B is bucketed when
    ``batch_buckets`` is given, with all-pad rows appended.
    """
    if raw_uint8 and (add_bos or add_eos):
        raise ValueError("raw_uint8 wire cannot carry BOS/EOS specials")
    cap = max_len_cap if max_len_cap is not None else buckets[-1]
    off = int(add_bos)
    bufs = [t.encode("utf-8") for t in texts]
    rows = len(bufs)
    lens = np.fromiter((len(b) for b in bufs), dtype=np.int64, count=rows)
    totals = np.minimum(off + lens + int(add_eos), cap)
    L = bucket_length(max(1, int(totals.max()) if rows else 1), buckets)
    totals = np.minimum(totals, L)
    B = bucket_length(max(1, rows), batch_buckets) if batch_buckets else rows
    ids = np.zeros((B, L), dtype=np.uint8 if raw_uint8 else np.int32)
    lengths = np.zeros(B, dtype=np.int32)
    lengths[:rows] = totals
    nb = np.zeros(B, dtype=np.int64)  # body bytes of each row
    nb[:rows] = np.minimum(np.maximum(totals - off, 0), lens)
    if rows:
        # One vectorised gather from the joined bytes instead of a per-row
        # copy loop.
        flat = np.frombuffer(b"".join(bufs), dtype=np.uint8)
        starts = np.zeros(rows, dtype=np.int64)
        if rows > 1:
            np.cumsum(lens[:-1], out=starts[1:])
        cols = np.arange(L, dtype=np.int64)[None, :]
        body = (cols >= off) & (cols < off + nb[:rows, None])
        if flat.size:
            src = np.clip(starts[:, None] + (cols - off), 0, flat.size - 1)
            ids[:rows][body] = flat[src][body]
    if raw_uint8:
        return ids, lengths
    cols = np.arange(L)[None, :]
    body = (cols >= off) & (cols < off + nb[:, None])
    ids[body] += N_SPECIAL  # every body byte, NULs included
    if add_bos and rows:
        ids[:rows, 0][totals > 0] = BOS_ID
    if add_eos and rows:
        fits = np.flatnonzero(off + lens + 1 <= np.minimum(cap, L))
        ids[fits, (off + nb[fits]).astype(np.int64)] = EOS_ID
    return ids, lengths


def pad_batch(
    seqs: Sequence[Sequence[int]],
    buckets: Sequence[int] = DEFAULT_BUCKETS,
    pad_id: int = PAD_ID,
    batch_buckets: Optional[Sequence[int]] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Ragged int lists -> (ids[B, L] int32, mask[B, L] int32) with bucketed
    shapes; sequences longer than the top bucket are truncated."""
    max_len = max((len(s) for s in seqs), default=1)
    L = bucket_length(max(1, max_len), buckets)
    rows = len(seqs)
    B = bucket_length(max(1, rows), batch_buckets) if batch_buckets else rows
    ids = np.full((B, L), pad_id, dtype=np.int32)
    mask = np.zeros((B, L), dtype=np.int32)
    for r, s in enumerate(seqs):
        s = list(s)[:L]
        ids[r, : len(s)] = s
        mask[r, : len(s)] = 1
    return ids, mask
