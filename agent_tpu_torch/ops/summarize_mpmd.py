"""Summarize split into an encode op and a decode op that can run on
different agents (MPMD) — counterpart of ``agent_tpu.ops.summarize_mpmd``.

An encode-stage agent (``TASKS=summarize_encode``) leases text shards and
posts encoder activations; a decode-stage agent (``TASKS=summarize_decode``)
leases the dep-gated decode job whose ``partials`` the controller filled
from the encode results, and posts the summaries. The controller's
dependency gating is the queue between the stages.

The wire between them is an ordinary result body:

    {ok, op: "summarize_encode", model, n_rows, empty_rows,
     chunks: [{enc: [B][Ls][d] f32, lengths: [B], n: int}, ...]}

Activations travel as JSON floats; an f32 -> JSON -> f32 round trip is
exact, so the decode stage resumes from the encoder's very rows. The
encoder attends through the runtime's attention function (the flash kernel
on the card); the decode is ``seq2seq.greedy_generate_from_encoded``. These
ops serve the in-house seq2seq family, quantized when ``model_config``
asks.

On a mesh with ``dp`` or ``tp`` both stages run ``map_summarize``'s sharded
seq2seq: the encode stage stages by dp and encodes over the shards, and the
handoff stays the whole [B, L, d] output. The decode stage splits its rows
over dp when they divide it (a batch staged by another agent's mesh need
not), else runs on replica 0's tp group, counted under
``SELECTION_COUNTS["unsharded"]`` (the reference's ``_put``).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from agent_tpu_torch.ops import register_op
from agent_tpu_torch.ops._model_common import device_runtime, resolve_runtime, stage_divisor
from agent_tpu_torch.utils.errors import bad_input

DEFAULT_MAX_LENGTH = 130


def _resolve(payload: Dict[str, Any]):
    from agent_tpu_torch.models.seq2seq import Seq2SeqConfig
    from agent_tpu_torch.ops._model_common import config_from_payload, resolve_model_id

    model_id = resolve_model_id(payload, "BART_MODEL", "summarize-default")
    # The quant mode is the payload's model_config alone (no TPU_QUANT), as
    # the reference's serving ops resolve it; a mode other than int8/w8a16
    # serves float weights.
    return model_id, config_from_payload(payload, Seq2SeqConfig)


def _get_params(runtime, model_id: str, cfg):
    """``map_summarize``'s seq2seq weights, under its key (one copy)."""
    from agent_tpu_torch.ops.map_summarize import _get_model

    return _get_model(runtime, model_id, cfg, "seq2seq")


def _collect_texts(payload: Dict[str, Any]) -> Tuple[List[str], List[int]]:
    """-> (texts, empty_rows), map_summarize's drain contract: a blank CSV
    cell gets an empty summary."""
    texts = payload.get("texts")
    empty_rows: List[int] = []
    if texts is None and "source_uri" in payload:
        from agent_tpu_torch.data.csv_index import read_shard_texts

        texts = read_shard_texts(payload)  # ValueError -> soft; I/O raises
        empty_rows = [i for i, t in enumerate(texts) if not t]
        if empty_rows:
            texts = [t or " " for t in texts]
    if not isinstance(texts, list) or not texts or not all(
            isinstance(t, str) and t for t in texts):
        raise ValueError("payload requires 'texts' (non-empty strings) or 'source_uri' "
                         "shard addressing")
    return texts, empty_rows


@register_op("summarize_encode")
def run_encode(payload: Any, ctx: Optional[object] = None) -> Dict[str, Any]:
    """Encoder stage: texts -> encoder activations (the wire between the
    stages)."""
    t0 = time.perf_counter()
    if not isinstance(payload, dict):
        return bad_input("payload must be a dict")
    try:
        texts, empty_rows = _collect_texts(payload)
        model_id, cfg = _resolve(payload)
        dp = stage_divisor(resolve_runtime(ctx), cfg, "seq2seq")
    except ValueError as exc:
        return bad_input(str(exc))

    from agent_tpu_torch.models import seq2seq
    from agent_tpu_torch.ops.map_summarize import _stage_chunks

    runtime = device_runtime(ctx, "summarize_encode")
    chunks = _stage_chunks(texts, cfg, 1, "seq2seq", model_id, dp)
    model = _get_params(runtime, model_id, cfg)
    attn_fn = runtime.attention_fn()
    out_chunks = []
    with torch.inference_mode():
        for ids, lengths, n in chunks:
            Ls = ids.shape[1]
            n_t = runtime.put_batch(lengths)
            mask = (torch.arange(Ls, device=n_t.device)[None, :] < n_t[:, None]).to(torch.int32)
            # f32 on the wire whatever the compute dtype: an exact JSON round
            # trip, and the decode stage casts back to its compute dtype.
            enc = seq2seq.encode(model, runtime.put_batch(ids), mask, attn_fn).float()
            out_chunks.append({"enc": enc.cpu().numpy().tolist(),
                               "lengths": np.asarray(lengths).astype(int).tolist(),
                               "n": int(n)})
    return {
        "ok": True,
        "op": "summarize_encode",
        "model": model_id,
        "device": runtime.platform,
        "n_rows": len(texts),
        "empty_rows": empty_rows,
        "chunks": out_chunks,
        "elapsed_ms": (time.perf_counter() - t0) * 1000.0,
    }


def _encoded_inputs(payload: Dict[str, Any]) -> List[Dict[str, Any]]:
    """The encode-stage results to decode: ``encoded`` (one result) or
    ``partials`` (the controller's dep-gated materialization)."""
    if "encoded" in payload:
        sources = [payload["encoded"]]
    elif "partials" in payload:
        sources = payload["partials"]
    else:
        raise ValueError("payload requires 'encoded' (one summarize_encode result) or "
                         "dep-gated 'partials'")
    if not isinstance(sources, list) or not sources:
        raise ValueError("no encode-stage results to decode")
    for src in sources:
        if not (isinstance(src, dict) and src.get("op") == "summarize_encode"
                and isinstance(src.get("chunks"), list) and src["chunks"]):
            raise ValueError("each encoded input must be a summarize_encode result "
                             "carrying 'chunks'")
    return sources


@register_op("summarize_decode")
def run_decode(payload: Any, ctx: Optional[object] = None) -> Dict[str, Any]:
    """Decoder stage: encoder activations -> summaries (greedy).
    ``model_config``/``model_path`` must match the encode stage's: the
    decoder resumes with the same seeded weights."""
    t0 = time.perf_counter()
    if not isinstance(payload, dict):
        return bad_input("payload must be a dict")
    try:
        sources = _encoded_inputs(payload)
    except ValueError as exc:
        return bad_input(str(exc))
    max_new = payload.get("max_length", DEFAULT_MAX_LENGTH)
    if isinstance(max_new, bool) or not isinstance(max_new, int) or max_new <= 0:
        return bad_input("max_length must be a positive int")
    try:
        model_id, cfg = _resolve(payload)
        stage_divisor(resolve_runtime(ctx), cfg, "seq2seq")  # pp or ep: bad_input
    except ValueError as exc:
        return bad_input(str(exc))
    max_new = min(max_new, cfg.max_tgt_len)

    from agent_tpu_torch.models import seq2seq
    from agent_tpu_torch.models.tokenizer import ByteTokenizer

    runtime = device_runtime(ctx, "summarize_decode")
    model = _get_params(runtime, model_id, cfg)
    tok = ByteTokenizer()
    summaries: List[str] = []
    n_rows = 0
    for src in sources:
        src_summaries: List[str] = []
        for chunk in src["chunks"]:
            enc = np.asarray(chunk["enc"], dtype=np.float32)
            lengths = np.asarray(chunk["lengths"], dtype=np.int32)
            n = int(chunk["n"])
            if enc.ndim != 3 or lengths.ndim != 1 or enc.shape[0] != lengths.shape[0]:
                return bad_input(f"malformed encode chunk: enc {enc.shape}, "
                                 f"lengths {lengths.shape}")
            Ls = enc.shape[1]
            with torch.inference_mode():
                n_t = runtime.put_batch(lengths)
                mask = (torch.arange(Ls, device=n_t.device)[None, :]
                        < n_t[:, None]).to(torch.int32)
                toks, _ = seq2seq.greedy_generate_from_encoded(
                    model, runtime.put_batch(enc), mask, max_new)
            src_summaries.extend(tok.decode([t for t in row if t > 0])
                                 for row in toks.cpu().numpy()[:n])
        for i in src.get("empty_rows") or []:
            if 0 <= int(i) < len(src_summaries):
                src_summaries[int(i)] = ""  # drain blanks stay blank
        summaries.extend(src_summaries)
        n_rows += len(src_summaries)
    return {
        "ok": True,
        "op": "summarize_decode",
        "model": model_id,
        "device": runtime.platform,
        "n_rows": n_rows,
        "summaries": summaries,
        "elapsed_ms": (time.perf_counter() - t0) * 1000.0,
    }
