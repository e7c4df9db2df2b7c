"""Autoregressive decode engines, greedy and beam — counterpart of
``agent_tpu.models.decoding`` (``greedy_scan``, ``beam_scan``,
``_ban_eos_before``, ``_bank_hypotheses``, and the continuous-batching
``ContinuousBatcher`` with its ``DecodeTicket`` and ``KVPoolExhausted``).

The model supplies a step function and its caches; the engine supplies the
control flow, the EOS bookkeeping and, for beam search, the joint top-K and
the cache reordering. The reference runs each engine as one compiled
``lax.while_loop``; here each is a Python loop over device tensors, one
decoder step a trip. The semantics are the reference's (HF
``BeamSearchScorer``-exact beam search), and so is the early exit: the loop
stops once every row is done, which reads a flag on the host each step (one
device synchronisation a step) and changes no output.

Every top-k here is a stable descending sort, which breaks ties toward the
lower index as ``lax.top_k`` does (``torch.topk`` leaves tie order
unspecified).

``step_fn(tok [B], step int, caches) -> (logits [B, V] f32, caches)``.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from agent_tpu_torch.models.layers import NEG_INF

StepFn = Callable[[torch.Tensor, int, Any], Tuple[torch.Tensor, Any]]
# The continuous engine's step: ``(tok [R], pos [R], caches, enc_state,
# enc_mask [R, Ls]) -> (logits [R, V] f32, caches)``, positions a tensor
# (each slot of the running batch at its own depth) and the encoder state an
# argument (slots join with their own prefill output); its
# ``encoder_state(rows [n, Ls, d] f32)`` turns joining rows into that state
# (``seq2seq.PositionalStep``).
PositionalStepFn = Callable[[torch.Tensor, torch.Tensor, Any, Any, torch.Tensor],
                            Tuple[torch.Tensor, Any]]


class KVPoolExhausted(Exception):
    """A request's worst-case KV reservation exceeds the whole pool, so it
    can never be seated (the serving layer's 429). A request that only has
    to wait for blocks stays in the backlog: the engine reserves a request's
    ``ceil(limit / block_size)`` blocks per beam row when it seats it, so a
    seated request never runs out of blocks mid-decode."""


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: values and indices, descending,
    ties toward the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _ban_eos_before(scores: torch.Tensor, step: int, min_length: int,
                    eos_id: int) -> torch.Tensor:
    """HF ``MinLengthLogitsProcessor``: EOS masked to ``NEG_INF`` while the
    decoder sequence (start token + generated, HF's counting = step + 1) is
    below ``min_length``. ``scores``: [..., V] logits or logprobs."""
    if min_length <= 0 or step + 1 >= min_length:
        return scores
    out = scores.clone()
    out[..., eos_id] = NEG_INF
    return out


def _ban_eos_before_rows(scores: torch.Tensor, pos: torch.Tensor, min_length: int,
                         eos_id: int) -> torch.Tensor:
    """Per-row :func:`_ban_eos_before` for the continuous engine: ``scores``
    [S, ..., V], ``pos`` [S] each slot's step."""
    if min_length <= 0:
        return scores
    cond = (pos + 1 < min_length).view((scores.shape[0],) + (1,) * (scores.ndim - 2))
    out = scores.clone()
    out[..., eos_id] = torch.where(cond, torch.tensor(NEG_INF, dtype=scores.dtype,
                                                      device=scores.device), out[..., eos_id])
    return out


def _bank_hypotheses(K: int, fin_scores: torch.Tensor, fin_toks: torch.Tensor,
                     cand_norm: torch.Tensor,
                     cand_toks: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge candidate hypotheses into the K-slot finished store.
    ``cand_norm`` [B, n] (``-inf`` = ineligible), ``cand_toks`` [B, n, T]."""
    all_scores = torch.cat([fin_scores, cand_norm], dim=1)
    all_toks = torch.cat([fin_toks, cand_toks], dim=1)
    new_scores, sel = _top_k(all_scores, K)                  # [B, K]
    return new_scores, torch.gather(all_toks, 1, sel[:, :, None].expand(-1, -1,
                                                                        all_toks.shape[2]))


def _lengths(toks: torch.Tensor, pad_id: int, eos_id: int) -> torch.Tensor:
    return ((toks != pad_id) & (toks != eos_id)).sum(dim=1)


def greedy_scan(
    step_fn: StepFn,
    caches: Any,
    batch: int,
    max_new_tokens: int,
    *,
    start_id: int,
    eos_id: int,
    pad_id: int = 0,
    min_length: int = 0,
    forced_first_id: Optional[int] = None,
    forced_last_id: Optional[int] = None,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy decode -> (tokens [B, T] int32, lengths [B]).

    Rows emit ``pad_id`` after their EOS; ``min_length`` bans EOS while the
    sequence is shorter. ``forced_first_id`` (BART's
    ``forced_bos_token_id``) replaces the argmax at step 0, and
    ``forced_last_id`` (``forced_eos_token_id``) at the last step, when set;
    a forced last token wins over ``min_length``, HF's processor order. The
    loop stops once every row has emitted EOS; the untouched tail is already
    ``pad_id``, what the remaining steps would have written. ``device`` is
    where the tokens live (the caches' device)."""
    tok = torch.full((batch,), start_id, dtype=torch.int32, device=device)
    done = torch.zeros((batch,), dtype=torch.bool, device=device)
    toks = torch.full((batch, max_new_tokens), pad_id, dtype=torch.int32, device=device)
    for step in range(max_new_tokens):
        if step and bool(done.all()):
            break
        logits, caches = step_fn(tok, step, caches)
        logits = _ban_eos_before(logits, step, min_length, eos_id)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        if forced_first_id is not None and step == 0:
            nxt = torch.full_like(nxt, forced_first_id)
        if forced_last_id is not None and step == max_new_tokens - 1:
            nxt = torch.full_like(nxt, forced_last_id)
        nxt = torch.where(done, pad_id, nxt)
        done = done | (nxt == eos_id)
        toks[:, step] = nxt
        tok = nxt
    return toks, _lengths(toks, pad_id, eos_id)


def _reorder(c: torch.Tensor, beam_idx: torch.Tensor) -> torch.Tensor:
    """Rows [B·K, ...] -> the rows of each batch entry's beams in
    ``beam_idx`` [B, K] order (copied to ``c``'s device: a shard's cache
    on another card)."""
    B, K = beam_idx.shape
    x = c.view(B, K, *c.shape[1:])
    rows = torch.arange(B, device=c.device)[:, None]
    return x[rows, beam_idx.to(c.device, non_blocking=True).long()].reshape(c.shape)


def _reorder_all(caches: Any, beam_idx: torch.Tensor) -> Any:
    """:func:`_reorder` over every tensor of nested dicts and lists. A
    mesh's ``{"replicas": [...]}`` (``models.sharded_decoder``) gives each dp
    replica's caches its own rows of ``beam_idx``."""
    if isinstance(caches, dict) and "replicas" in caches:
        reps = caches["replicas"]
        return {"replicas": [_reorder_all(r, b)
                             for r, b in zip(reps, beam_idx.chunk(len(reps)))]}
    if isinstance(caches, dict):
        return {k: _reorder_all(v, beam_idx) for k, v in caches.items()}
    if isinstance(caches, list):
        return [_reorder_all(v, beam_idx) for v in caches]
    return _reorder(caches, beam_idx)


def beam_scan(
    step_fn: StepFn,
    caches: Any,
    batch: int,
    vocab_size: int,
    max_new_tokens: int,
    *,
    num_beams: int,
    start_id: int,
    eos_id: int,
    pad_id: int = 0,
    length_penalty: float = 1.0,
    early_stopping: bool = False,
    min_length: int = 0,
    forced_first_id: Optional[int] = None,
    forced_last_id: Optional[int] = None,
    cache_reorder: str = "delta",
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam-search decode -> (tokens [B, T], lengths [B]), HF
    ``BeamSearchScorer`` semantics as the reference's ``beam_scan``: each
    step takes the top-2K candidates of the joint ``[B, K·V]`` scores; EOS
    candidates ranked < K bank their hypothesis into a K-slot finished
    store, normalised by ``(step + 1) ** length_penalty``; the K best
    non-EOS candidates continue (reordering the caches along the beam
    axis). A row closes once its store holds K hypotheses and either
    ``early_stopping`` is set or the best running beam can no longer beat
    the worst banked one. After the loop, the running beams of rows that
    never closed bank at full length; each row emits its best hypothesis.
    ``num_beams=1`` emits greedy's tokens. A forced first (last) id replaces
    the whole log-probability row at step 0 (the last step) with 0 for that
    id and ``NEG_INF`` elsewhere, after the ``min_length`` ban (HF's
    processor order, so a forced EOS wins).

    ``cache_reorder``: ``"delta"`` (default) skips the cache gather on steps
    where every beam extends its own parent; ``"gather"`` always gathers.
    Outputs are identical."""
    if cache_reorder not in ("delta", "gather"):
        raise ValueError(
            f"cache_reorder must be 'delta' or 'gather', got {cache_reorder!r}"
        )
    B, K, V, T = batch, num_beams, vocab_size, max_new_tokens
    K2 = 2 * K
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    tok = torch.full((B * K,), start_id, **i32)
    # Step 0: all K beams are identical, so only beam 0 may survive top-K.
    scores = torch.tensor([0.0] + [NEG_INF] * (K - 1), **f32).repeat(B, 1)
    toks = torch.full((B, K, T), pad_id, **i32)
    # Empty finished slots are -inf, not the finite NEG_INF: with a negative
    # length_penalty a real hypothesis can normalise below -1e9.
    fin_scores = torch.full((B, K), -float("inf"), **f32)
    fin_toks = torch.full((B, K, T), pad_id, **i32)
    row_done = torch.zeros((B,), dtype=torch.bool, device=device)
    arange_k = torch.arange(K, **i32)[None, :]
    rank_lt_k = torch.arange(K2, device=device)[None, :] < K

    def forced_row(token: Optional[int]) -> Optional[torch.Tensor]:
        if token is None:
            return None
        row = torch.full((V,), NEG_INF, **f32)
        row[token] = 0.0
        return row

    forced_first, forced_last = forced_row(forced_first_id), forced_row(forced_last_id)

    def pow_lp(n: int) -> torch.Tensor:
        """n ** length_penalty in f32, as the reference computes it, as a
        device tensor (CUDA divides by a host scalar through its
        reciprocal, which can differ in the last bit)."""
        return torch.tensor(np.float32(n) ** np.float32(length_penalty), **f32)

    for step in range(T):
        if step and bool(row_done.all()):
            break
        logits, caches = step_fn(tok, step, caches)              # [B·K, V]
        logp = torch.log_softmax(logits.float(), dim=-1).view(B, K, V)
        logp = _ban_eos_before(logp, step, min_length, eos_id)
        if forced_first is not None and step == 0:
            logp = forced_first.expand(B, K, V)
        if forced_last is not None and step == T - 1:
            logp = forced_last.expand(B, K, V)
        flat = (scores[:, :, None] + logp).view(B, K * V)
        cand_scores, idx = _top_k(flat, K2)                      # [B, 2K]
        cand_beam = idx // V                                     # parent beam
        cand_tok = (idx % V).to(torch.int32)
        is_eos = cand_tok == eos_id

        # Bank EOS candidates: ranks < K only, and only while the row is
        # open; hypothesis length = start + step generated = step + 1.
        eligible = is_eos & rank_lt_k & ~row_done[:, None]
        cand_norm = torch.where(eligible, cand_scores / pow_lp(step + 1), -float("inf"))
        cand_toks = torch.gather(toks, 1, cand_beam[:, :, None].expand(-1, -1, T))
        cand_toks[:, :, step] = eos_id
        fin_scores, fin_toks = _bank_hypotheses(K, fin_scores, fin_toks, cand_norm,
                                                cand_toks)

        # Continue with the K best non-EOS candidates (cand_scores are
        # sorted, so the stable top-k keeps score order).
        _, gather_pos = _top_k(torch.where(is_eos, -float("inf"), cand_scores), K)
        new_scores = torch.gather(cand_scores, 1, gather_pos)
        new_tok = torch.gather(cand_tok, 1, gather_pos)
        beam_idx = torch.gather(cand_beam, 1, gather_pos).to(torch.int32)

        # Rows already done freeze: pad, frozen scores, and each beam keeps
        # its own slot (identity, so the delta reorder skips them).
        done = row_done[:, None]
        new_scores = torch.where(done, scores, new_scores)
        new_tok = torch.where(done, pad_id, new_tok)
        beam_idx = torch.where(done, arange_k, beam_idx)

        toks = torch.gather(toks, 1, beam_idx[:, :, None].long().expand(-1, -1, T))
        toks[:, :, step] = new_tok

        # HF is_done: store full AND (early_stopping, or the best running
        # beam can no longer beat the banked worst at this length).
        full = torch.isfinite(fin_scores[:, K - 1])
        if early_stopping:
            newly_done = full
        else:
            best_running = new_scores[:, 0] / pow_lp(step + 1)
            newly_done = full & (best_running <= fin_scores[:, K - 1])
        row_done = row_done | newly_done

        if cache_reorder == "gather" or not bool((beam_idx == arange_k).all()):
            caches = _reorder_all(caches, beam_idx)
        tok = new_tok.reshape(B * K)
        scores = new_scores

    # Rows that never closed bank their running beams, normalised by their
    # generated length T.
    run_norm = torch.where(row_done[:, None], -float("inf"), scores / pow_lp(T))
    fin_scores, fin_toks = _bank_hypotheses(K, fin_scores, fin_toks, run_norm, toks)
    out = fin_toks[:, 0]                                         # [B, T]
    return out, _lengths(out, pad_id, eos_id)



# ---------------------------------------------------------------------------
# Iteration-level continuous batching
# ---------------------------------------------------------------------------

def _tree_leaves(tree: Any) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tree_leaves(v)]
    return [tree]


def _tree_zeros(tree: Any, rows: int) -> Any:
    """``tree`` with every leaf replaced by zeros of ``rows`` leading rows."""
    if isinstance(tree, dict):
        return {k: _tree_zeros(v, rows) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_zeros(v, rows) for v in tree)
    return tree.new_zeros((rows,) + tuple(tree.shape[1:]))


def paged_shards(caches: dict) -> List[dict]:
    """A paged cache's per-shard ``{"table", "layers"}`` parts: its
    ``"shards"`` on a tp group, else the one device's cache itself."""
    return caches.get("shards", [caches])


class DecodeTicket:
    """One request's seat in the continuous engine: the prefill handoff in,
    the emitted tokens out, and its lifecycle: the admit, join (``seat``),
    first-token and done walls, the wait on KV blocks (``kv_wait_s``, the
    paged pool's FIFO head-of-line wait), the engine step at join, the
    running batch's occupancy when it was seated, and an ordered
    ``events`` list of ``(name, wall)`` stamps (``admit``, ``kv_wait``,
    ``seat``, ``first_token``, ``exit``)."""

    __slots__ = (
        "data", "limit", "enc_row", "mask_row", "slot",
        "admitted_wall", "joined_wall", "first_token_wall", "done_wall",
        "tokens", "length", "steps",
        "kv_wait_start", "kv_wait_s", "join_step", "occupancy_at_join",
        "events",
    )

    def __init__(self, enc_row, mask_row, limit: int, data: Any = None) -> None:
        self.data = data
        self.limit = int(limit)
        self.enc_row = enc_row
        self.mask_row = mask_row
        self.slot: Optional[int] = None
        self.admitted_wall: Optional[float] = None
        self.joined_wall: Optional[float] = None
        self.first_token_wall: Optional[float] = None
        self.done_wall: Optional[float] = None
        self.tokens: Optional[np.ndarray] = None
        self.length: int = 0
        self.steps: int = 0
        self.kv_wait_start: Optional[float] = None
        self.kv_wait_s: float = 0.0
        self.join_step: int = 0
        self.occupancy_at_join: int = 0
        self.events: List[Tuple[str, float]] = []


class ContinuousBatcher:
    """Iteration-level continuous batching over a fixed-capacity running
    batch of ``slots`` requests (× ``num_beams`` beam rows each), the
    reference's engine:

    - a finished sequence leaves between steps (its slot frees when the
      per-slot done flag trips: EOS or banked-full for beam, EOS or the
      per-slot token ``limit`` for greedy);
    - a queued sequence joins between steps (:meth:`_insert` writes its
      rows and resets its slot; the other slots are not touched);
    - every slot carries its own position, so each request's tokens are
      those of a solo ``greedy_scan``/``beam_scan`` of it with its own
      budget.

    Prefill is the caller's: it encodes, then admits ``(enc_row, mask_row,
    limit)`` per request (:meth:`admit`). ``step_fn`` is a
    :data:`PositionalStepFn`; the engine stores what its
    ``encoder_state`` returns for the joining rows (the seq2seq's
    cross-attention K/V).

    State is tensors on the caches' device, updated in place by plain
    methods under ``torch.inference_mode`` (:meth:`admit` and :meth:`step`
    enter it); the host reads ``pos`` and ``row_done`` once after each
    :meth:`step` (``micro_steps`` decode iterations issued back to back),
    and beam search's ``"delta"`` reorder reads whether any beam changed
    parent each iteration. The paged layout's block allocator is host
    state: a table mirror and a free list, pushed to the device when seats
    and releases change it.
    """

    def __init__(
        self,
        step_fn: PositionalStepFn,
        cache_factory: Callable[[int], Any],
        *,
        slots: int,
        vocab_size: int,
        max_tokens: int,
        enc_len: int,
        d_model: int,
        start_id: int,
        eos_id: int,
        pad_id: int = 0,
        num_beams: int = 1,
        min_length: int = 0,
        length_penalty: float = 1.0,
        early_stopping: bool = False,
        cache_reorder: str = "delta",
        micro_steps: int = 1,
        clock: Callable[[], float] = time.time,
    ) -> None:
        if slots < 1:
            raise ValueError("slots must be >= 1")
        if num_beams < 1:
            raise ValueError("num_beams must be >= 1")
        if micro_steps < 1:
            raise ValueError("micro_steps must be >= 1")
        if cache_reorder not in ("delta", "gather"):
            raise ValueError(f"cache_reorder must be 'delta' or 'gather', got {cache_reorder!r}")
        self.step_fn = step_fn
        self.slots = int(slots)
        self.K = int(num_beams)
        self.V = int(vocab_size)
        self.T = int(max_tokens)
        self.enc_len = int(enc_len)
        self.start_id = int(start_id)
        self.eos_id = int(eos_id)
        self.pad_id = int(pad_id)
        self.min_length = int(min_length)
        self.length_penalty = float(length_penalty)
        self.early_stopping = bool(early_stopping)
        self.cache_reorder = cache_reorder
        self.beam = self.K > 1
        self.micro_steps = int(micro_steps)
        self._clock = clock
        S, K, T, R = self.slots, self.K, self.T, self.slots * self.K
        caches = cache_factory(R)
        dev = _tree_leaves(caches)[0].device
        self.device = dev
        i32 = dict(dtype=torch.int32, device=dev)
        # Paged KV, detected from the factory's structure
        # (seq2seq.make_paged_cache_factory): one block table, one pool per
        # tp shard, every pool of the same blocks.
        self.paged = isinstance(caches, dict) and "table" in caches
        if self.paged:
            table = caches["table"]
            if table.shape[0] != R:
                raise ValueError(f"paged cache table has {table.shape[0]} rows, engine "
                                 f"needs slots*num_beams={R}")
            pool = paged_shards(caches)[0]["layers"][0]["k"]
            self.kv_block_size = int(pool.shape[2])
            self.kv_max_blocks = int(table.shape[1])
            self.kv_pool_blocks = int(pool.shape[0])
            self._table_np = np.zeros((R, self.kv_max_blocks), dtype=np.int64)
            # Block 0 is the trash block: released and unallocated entries
            # point there, so a frozen row's rewrite of its last position
            # never lands in a block handed to another request.
            self._free_blocks: List[int] = list(range(1, self.kv_pool_blocks))
            self._slot_blocks: Dict[int, List[int]] = {}
            self._table_dirty = False
        # Empty slots are frozen rows (row_done): they ride every step as
        # pads and identity reorders, and reset when a request is inserted.
        dyn: Dict[str, Any] = {
            "tok": torch.full((R,), self.start_id, **i32),
            "pos": torch.zeros((S,), **i32),
            "row_done": torch.ones((S,), dtype=torch.bool, device=dev),
            "caches": caches,
        }
        if self.beam:
            dyn["scores"] = self._fresh_scores().repeat(S, 1)
            dyn["toks"] = torch.full((S, K, T), self.pad_id, **i32)
            dyn["fin_scores"] = torch.full((S, K), -float("inf"), dtype=torch.float32,
                                           device=dev)
            dyn["fin_toks"] = torch.full((S, K, T), self.pad_id, **i32)
        else:
            dyn["toks"] = torch.full((S, T), self.pad_id, **i32)
        self._dyn = dyn
        probe = step_fn.encoder_state(torch.zeros((1, self.enc_len, d_model),
                                                  dtype=torch.float32, device=dev))
        self._stat: Dict[str, Any] = {
            "limit": torch.ones((S,), **i32),
            "enc": _tree_zeros(probe, R),
            "enc_mask": torch.zeros((R, self.enc_len), **i32),
        }
        # n ** length_penalty in f32 for n = 0..T + 1 (a slot frozen at T
        # reads T + 1), computed on the host as beam_scan computes it, so a
        # slot's normalisation is a solo decode's.
        with np.errstate(divide="ignore"):  # 0 ** a negative penalty: never read
            self._lp_pow = torch.from_numpy(
                np.arange(T + 2, dtype=np.float32) ** np.float32(self.length_penalty)).to(dev)
        self._arange_s = torch.arange(S, device=dev)
        self._live: Dict[int, DecodeTicket] = {}
        self._free: List[int] = list(range(S))
        self._backlog: List[DecodeTicket] = []
        # Occupancy accounting (the serve_batch_occupancy gauge's feed).
        self.steps_run = 0
        self.occupancy_sum = 0
        self.max_occupancy = 0
        self.tokens_emitted = 0

    def _fresh_scores(self) -> torch.Tensor:
        """A slot's starting beam scores: beam 0 alone may survive step 0."""
        return torch.tensor([0.0] + [NEG_INF] * (self.K - 1), dtype=torch.float32,
                            device=self.device)

    # ---- device steps ----

    def _step_greedy(self) -> None:
        d, stat = self._dyn, self._stat
        T = self.T
        pos, row_done = d["pos"], d["row_done"]
        logits, d["caches"] = self.step_fn(d["tok"], pos, d["caches"], stat["enc"],
                                           stat["enc_mask"])
        logits = _ban_eos_before_rows(logits, pos, self.min_length, self.eos_id)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        nxt = torch.where(row_done, self.pad_id, nxt)
        # A frozen slot's tokens stay as they are until the host extracts
        # them or the slot is reseated (the reference drops its write).
        col = pos.long().clamp(max=T - 1)
        toks = d["toks"]
        toks[self._arange_s, col] = torch.where(row_done, toks[self._arange_s, col], nxt)
        new_pos = torch.where(row_done, pos, pos + 1)
        d["row_done"] = row_done | (nxt == self.eos_id) | (new_pos >= stat["limit"])
        d["tok"], d["pos"] = nxt, new_pos

    def _step_beam(self) -> None:
        """``beam_scan``'s body with the scalar step replaced by the slots'
        ``pos``, plus the per-slot limit banking a solo ``beam_scan`` does
        after its loop."""
        d, stat = self._dyn, self._stat
        S, K, V, T = self.slots, self.K, self.V, self.T
        K2 = 2 * K
        ninf = -float("inf")
        pos, row_done = d["pos"], d["row_done"]
        scores, toks = d["scores"], d["toks"]
        fin_scores, fin_toks = d["fin_scores"], d["fin_toks"]

        logits, d["caches"] = self.step_fn(d["tok"], pos.repeat_interleave(K), d["caches"],
                                           stat["enc"], stat["enc_mask"])
        logp = torch.log_softmax(logits.float(), dim=-1).view(S, K, V)
        logp = _ban_eos_before_rows(logp, pos, self.min_length, self.eos_id)
        flat = (scores[:, :, None] + logp).view(S, K * V)
        cand_scores, idx = _top_k(flat, K2)                       # [S, 2K]
        cand_beam = idx // V
        cand_tok = (idx % V).to(torch.int32)
        is_eos = cand_tok == self.eos_id

        # Bank EOS candidates (ranks < K, open slots only); the hypothesis
        # length is the slot's own: pos + 1.
        hyp = self._lp_pow[(pos + 1).long()]                      # [S]
        rank_lt_k = torch.arange(K2, device=pos.device)[None, :] < K
        eligible = is_eos & rank_lt_k & ~row_done[:, None]
        cand_norm = torch.where(eligible, cand_scores / hyp[:, None], ninf)
        cand_toks = torch.gather(toks, 1, cand_beam[:, :, None].expand(-1, -1, T))
        col = pos.long().clamp(max=T - 1)
        ar, frozen = self._arange_s, row_done[:, None]
        cand_toks[ar, :, col] = torch.where(frozen, cand_toks[ar, :, col], self.eos_id)
        fin_scores, fin_toks = _bank_hypotheses(K, fin_scores, fin_toks, cand_norm, cand_toks)

        # Continue with the K best non-EOS candidates; frozen slots keep
        # their own beams (identity).
        _, gather_pos = _top_k(torch.where(is_eos, ninf, cand_scores), K)
        new_scores = torch.gather(cand_scores, 1, gather_pos)
        new_tok = torch.gather(cand_tok, 1, gather_pos)
        beam_idx = torch.gather(cand_beam, 1, gather_pos)
        arange_k = torch.arange(K, device=pos.device)[None, :]
        new_scores = torch.where(frozen, scores, new_scores)
        new_tok = torch.where(frozen, self.pad_id, new_tok)
        beam_idx = torch.where(frozen, arange_k, beam_idx)

        toks = torch.gather(toks, 1, beam_idx[:, :, None].expand(-1, -1, T))
        toks[ar, :, col] = torch.where(frozen, toks[ar, :, col], new_tok)

        # HF is_done, per slot (beam_scan's rule).
        full = torch.isfinite(fin_scores[:, K - 1])
        if self.early_stopping:
            newly_done = full
        else:
            newly_done = full & (new_scores[:, 0] / hyp <= fin_scores[:, K - 1])
        row_done2 = row_done | newly_done

        # Per-slot limit: a slot out of budget banks its running beams
        # normalised by its own length, as a solo beam_scan(max_new=limit)
        # does after its loop.
        new_pos = torch.where(row_done, pos, pos + 1)
        reached = (new_pos >= stat["limit"]) & ~row_done2
        run_norm = torch.where(reached[:, None],
                               new_scores / self._lp_pow[stat["limit"].long()][:, None], ninf)
        fin_scores, fin_toks = _bank_hypotheses(K, fin_scores, fin_toks, run_norm, toks)

        if self.cache_reorder == "gather" or not bool((beam_idx == arange_k).all()):
            d["caches"] = (self._reorder_paged(d["caches"], beam_idx) if self.paged
                           else _reorder_all(d["caches"], beam_idx))
        d.update(tok=new_tok.reshape(S * K), pos=new_pos, row_done=row_done2 | reached,
                 scores=new_scores, toks=toks, fin_scores=fin_scores, fin_toks=fin_toks)

    def _reorder_paged(self, caches: dict, beam_idx: torch.Tensor) -> dict:
        """The paged beam reorder: blocks are row-exclusive (sibling beams
        diverge after sharing a parent), so each child row's blocks get a
        copy of its parent row's, logical block j from logical block j; the
        table is unchanged. Unallocated entries copy trash to trash. Every
        tp shard's pools copy the same blocks, under its copy of the table."""
        parent = (self._arange_s[:, None] * self.K + beam_idx).reshape(-1)
        for part in paged_shards(caches):
            table = part["table"]
            src = table[parent.to(table.device, non_blocking=True)].reshape(-1)
            dst = table.reshape(-1)
            for lc in part["layers"]:
                for name in ("k", "v"):
                    lc[name][dst] = lc[name][src]
        return caches

    def _insert(self, slot: int, enc_row, mask_row, limit: int) -> None:
        """Seat one request in ``slot``: its encoder state and mask in, its
        dense KV rows zeroed, its decode state reset. Nothing else moves."""
        d, stat, K = self._dyn, self._stat, self.K
        r0, r1 = slot * K, (slot + 1) * K
        dev = self.device
        row = torch.from_numpy(np.array(enc_row, dtype=np.float32)).to(dev)
        for buf, new in zip(_tree_leaves(stat["enc"]),
                            _tree_leaves(self.step_fn.encoder_state(row[None]))):
            buf[r0:r1] = new
        stat["enc_mask"][r0:r1] = torch.from_numpy(np.array(mask_row, dtype=np.int32)).to(dev)
        stat["limit"][slot] = int(limit)
        if not self.paged:
            # Paged rows need no zeroing: position j is written at step j,
            # before any step unmasks it.
            for c in _tree_leaves(d["caches"]):
                c[r0:r1] = 0
        d["tok"][r0:r1] = self.start_id
        d["pos"][slot] = 0
        d["row_done"][slot] = False
        if self.beam:
            d["scores"][slot] = self._fresh_scores()
            d["fin_scores"][slot] = -float("inf")
            d["fin_toks"][slot] = self.pad_id
        d["toks"][slot] = self.pad_id

    # ---- host loop ----

    @property
    def occupancy(self) -> int:
        """Requests currently seated in the running batch."""
        return len(self._live)

    @property
    def backlog(self) -> int:
        return len(self._backlog)

    def has_work(self) -> bool:
        return bool(self._live or self._backlog)

    def mean_occupancy(self) -> float:
        return self.occupancy_sum / self.steps_run if self.steps_run else 0.0

    # ---- paged-KV host allocator ----

    @property
    def kv_blocks_total(self) -> int:
        """Usable KV pool blocks (the trash block excluded); 0 when dense."""
        return (self.kv_pool_blocks - 1) if self.paged else 0

    @property
    def kv_blocks_free(self) -> int:
        return len(self._free_blocks) if self.paged else 0

    def _blocks_needed(self, limit: int) -> int:
        """The seat-time reservation: every beam row filled to ``limit``."""
        return self.K * (-(-limit // self.kv_block_size))

    def _allocate_blocks(self, slot: int, limit: int) -> None:
        per_row = -(-limit // self.kv_block_size)
        ids: List[int] = []
        for i in range(self.K):
            r = slot * self.K + i
            row_ids = [self._free_blocks.pop() for _ in range(per_row)]
            self._table_np[r, :] = 0
            self._table_np[r, :per_row] = row_ids
            ids.extend(row_ids)
        self._slot_blocks[slot] = ids
        self._table_dirty = True

    def _release_blocks(self, slot: int) -> None:
        ids = self._slot_blocks.pop(slot, None)
        if ids is None:
            return
        self._free_blocks.extend(ids)
        # Point the freed rows at the trash block before their blocks can be
        # handed out again: the empty slot's rows stay frozen in the batch
        # and keep writing K/V at their last position every step.
        self._table_np[slot * self.K:(slot + 1) * self.K, :] = 0
        self._table_dirty = True

    def _push_table(self) -> None:
        """The host table to every tp shard's copy (shards that share a
        device share one copy)."""
        if self.paged and self._table_dirty:
            src = torch.from_numpy(self._table_np)
            for table in {id(p["table"]): p["table"]
                          for p in paged_shards(self._dyn["caches"])}.values():
                table.copy_(src)
            self._table_dirty = False

    @torch.inference_mode()
    def admit(self, enc_row, mask_row, limit: int, data: Any = None) -> DecodeTicket:
        """Queue one request (its prefill output, mask and token budget). It
        joins at once if a slot (and, paged, its blocks) is free, else waits
        in the FIFO backlog and joins between steps. Paged: raises
        :class:`KVPoolExhausted` for a request whose reservation exceeds the
        whole pool."""
        limit = max(1, min(int(limit), self.T))
        if self.paged and self._blocks_needed(limit) > self.kv_blocks_total:
            raise KVPoolExhausted(
                f"request needs {self._blocks_needed(limit)} KV blocks (limit={limit} × "
                f"{self.K} beams, block_size={self.kv_block_size}), pool has "
                f"{self.kv_blocks_total}")
        ticket = DecodeTicket(enc_row, mask_row, limit, data=data)
        ticket.admitted_wall = self._clock()
        ticket.events.append(("admit", ticket.admitted_wall))
        self._backlog.append(ticket)
        self._fill_slots()
        return ticket

    def _fill_slots(self) -> None:
        while self._free and self._backlog:
            head = self._backlog[0]
            if self.paged and self._blocks_needed(head.limit) > len(self._free_blocks):
                # Head-of-line wait: FIFO order is part of the contract (a
                # later, smaller request must not overtake), so the queue
                # waits for releases. The wait's start is stamped once.
                if head.kv_wait_start is None:
                    head.kv_wait_start = self._clock()
                    head.events.append(("kv_wait", head.kv_wait_start))
                break
            ticket = self._backlog.pop(0)
            slot = self._free.pop(0)
            if self.paged:
                self._allocate_blocks(slot, ticket.limit)
            self._insert(slot, ticket.enc_row, ticket.mask_row, ticket.limit)
            ticket.slot = slot
            ticket.joined_wall = self._clock()
            if ticket.kv_wait_start is not None:
                ticket.kv_wait_s = max(0.0, ticket.joined_wall - ticket.kv_wait_start)
            ticket.join_step = self.steps_run
            ticket.enc_row = ticket.mask_row = None  # joined: drop the host copy
            self._live[slot] = ticket
            ticket.occupancy_at_join = len(self._live)
            ticket.events.append(("seat", ticket.joined_wall))

    def _extract(self, slots: List[int]) -> List[Tuple[np.ndarray, int]]:
        """The finished slots' tokens, in one read."""
        idx = torch.tensor(slots, device=self.device)
        src = self._dyn["fin_toks"][idx, 0] if self.beam else self._dyn["toks"][idx]
        out = []
        for row in src.cpu().numpy():
            out.append((row, int(((row != self.pad_id) & (row != self.eos_id)).sum())))
        return out

    @torch.inference_mode()
    def step(self) -> List[DecodeTicket]:
        """``micro_steps`` decode iterations of the running batch. Returns
        the tickets that finished; their slots are already reseated from the
        backlog (joins happen between steps, never inside one)."""
        if not self._live:
            self._fill_slots()
            if not self._live:
                return []
        self._push_table()
        step_impl = self._step_beam if self.beam else self._step_greedy
        for _ in range(self.micro_steps):
            step_impl()
        self.steps_run += self.micro_steps
        self.occupancy_sum += len(self._live) * self.micro_steps
        self.max_occupancy = max(self.max_occupancy, len(self._live))
        pos, done = torch.stack([self._dyn["pos"], self._dyn["row_done"].to(torch.int32)]
                                ).cpu().numpy()
        now = self._clock()
        finished: List[DecodeTicket] = []
        for slot, ticket in list(self._live.items()):
            if ticket.first_token_wall is None and pos[slot] >= 1:
                ticket.first_token_wall = now
                ticket.events.append(("first_token", now))
            if done[slot]:
                ticket.steps = int(pos[slot])
                ticket.done_wall = now
                ticket.events.append(("exit", now))
                del self._live[slot]
                self._free.append(slot)
                if self.paged:
                    self._release_blocks(slot)
                finished.append(ticket)
        if finished:
            for ticket, (toks, length) in zip(finished, self._extract(
                    [t.slot for t in finished])):
                ticket.tokens, ticket.length = toks, length
                self.tokens_emitted += max(ticket.steps, ticket.length)
            self._fill_slots()
        return finished

    def run(self, tickets: List[DecodeTicket]) -> None:
        """Step until every ticket in ``tickets`` finished (the monolithic
        path; the pipelined serving loop interleaves :meth:`step` with
        admissions instead)."""
        pending = {id(t) for t in tickets if t.done_wall is None}
        while pending:
            for t in self.step():
                pending.discard(id(t))
            if not self.has_work() and pending:
                raise RuntimeError("continuous engine drained with tickets outstanding")
