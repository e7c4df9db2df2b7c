"""Autoregressive decode engines, greedy and beam — counterpart of
``agent_tpu.models.decoding`` (``greedy_scan``, ``beam_scan``,
``_ban_eos_before``, ``_bank_hypotheses``).

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

from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from agent_tpu_torch.models.layers import NEG_INF

StepFn = Callable[[torch.Tensor, int, Any], Tuple[torch.Tensor, Any]]


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
    ``beam_idx`` [B, K] order."""
    B, K = beam_idx.shape
    x = c.view(B, K, *c.shape[1:])
    rows = torch.arange(B, device=c.device)[:, None]
    return x[rows, beam_idx.long()].reshape(c.shape)


def _reorder_all(caches: Any, beam_idx: torch.Tensor) -> Any:
    """:func:`_reorder` over every tensor of nested dicts and lists."""
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

