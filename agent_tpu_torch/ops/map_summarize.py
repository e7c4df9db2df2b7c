"""Summarization on the card — counterpart of ``agent_tpu.ops.map_summarize``
with the same op name, phases, payload and result contract.

- Payload: ``text`` or ``texts``, or CSV shard addressing (``source_uri``
  + ``start_row``/``shard_size`` + optional ``text_field``, read with
  ``data.csv_index.read_shard_texts``; a blank cell gets an empty summary),
  plus ``max_length`` (default 130), ``num_beams`` (1-16, default 1 =
  greedy), ``length_penalty``, ``early_stopping``, ``min_length``,
  ``model_path``, ``model_config``, ``output_uri`` / ``start_row``.
- Result: ``{ok, op, device, model, num_beams, elapsed_ms, summary}`` (plus
  ``summaries`` for ``texts`` and shards — a ``b1`` blob when the agent
  negotiated the binary wire — or an ``output_path`` receipt); caller
  errors come back as soft ``bad_input`` results with the reference's
  messages. A shard that cannot be read raises, so the task fails.
- Families, resolved from ``model_path`` as the reference does: a local HF
  BART checkpoint directory serves BART (:mod:`agent_tpu_torch.models.bart`,
  the reference's summarize model: text through the checkpoint's byte-level
  BPE, the encoder through ``runtime.attention_fn()``, generation with the
  checkpoint's forced first and last ids); a local HF T5 one serves T5 (the
  encoder's self-attention through the CUDA T5 kernel,
  ``runtime.t5_attention_kernel()``); anything else that is not a
  checkpoint directory serves the in-house seq2seq (seeded weights from the
  model id, or a ``.npz``), whose encoder attends through
  ``runtime.attention_fn()``. For a checkpoint, ``model_config`` may
  override only ``dtype`` and ``quant``; ``BART_MODEL`` names the default
  ``model_path``.
- ``SUMMARIZE_FORCE_CPU`` set to one of the reference's truthy tokens
  (``1``, ``true``, ``yes``, ``on``, ``y``) is the caller's explicit
  request for a CPU runtime; it is off by default. A failure on the card raises and fails the
  request; it is never retried on the CPU.

T5 text in and out needs the checkpoint's ``spiece.model`` and the
``sentencepiece`` package (``t5.hf_spm`` raises the reference's actionable
error without them); the device phase (:func:`_decode_chunks`) works on
staged ids alone.

``quant`` (``int8`` W8A8 or ``w8a16`` weight only; from the payload, else
``TPU_QUANT``, else the config) serves every family's block matmuls
quantized, in the encoder and in every decode step
(:mod:`agent_tpu_torch.models.quant`).

On a mesh with ``dp`` or ``tp`` (``MESH_SHAPE``) every family serves
sharded, as the reference's op: staging buckets the batch by dp, the weights
(quantized too) land split by ``parallel.shardings.LAYOUT_SPECS``
(:func:`_get_model`, ``models.sharded_decoder``), the encoder's kernel runs
once per (dp, tp) shard, and the decode loop runs on the mesh's first
device with each shard's step over its heads. A mesh with ``pp`` or ``ep``
is a ``bad_input``: no decoder runs over either.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from agent_tpu_torch.ops import register_op
from agent_tpu_torch.utils.errors import bad_input

DEFAULT_MODEL_ID = "summarize-default"
DEFAULT_MAX_LENGTH = 130
# Decode rows per dispatch chunk; beams multiply the rows in flight, so
# staging divides it by num_beams (the reference's budget).
MAX_DECODE_ROWS = 8192
_TRUTHY = ("1", "true", "yes", "on", "y")  # the reference's TRUTHY_TOKENS

_cpu_runtime = None
_cpu_runtime_lock = threading.Lock()


def _get_cpu_runtime():
    """The process's CPU runtime, for ``SUMMARIZE_FORCE_CPU=1``."""
    global _cpu_runtime
    with _cpu_runtime_lock:
        if _cpu_runtime is None:
            from agent_tpu_torch.runtime.runtime import TorchRuntime

            _cpu_runtime = TorchRuntime(device="cpu")
        return _cpu_runtime


def _resolve_family(model_id: str) -> str:
    """``"t5"`` for a local HF T5 checkpoint directory, ``"bart"`` for a BART
    one, ``"seq2seq"`` for anything that is not a checkpoint directory. Any
    other checkpoint directory, or one whose config.json cannot be read,
    raises: serving seeded weights for what was a checkpoint would return
    ok=true nonsense."""
    cfg_path = os.path.join(model_id, "config.json")
    if not (os.path.isdir(model_id) and os.path.exists(cfg_path)):
        return "seq2seq"
    try:
        with open(cfg_path) as f:
            model_type = json.load(f).get("model_type")
    except json.JSONDecodeError as exc:
        raise RuntimeError(f"unreadable checkpoint config.json at {cfg_path}: {exc}") from exc
    if model_type in ("bart", "t5"):
        return model_type
    raise RuntimeError(
        f"model_path {model_id!r} is a checkpoint directory but not a "
        "BART/T5 one (map_summarize serves model_type=bart|t5; "
        "classify serves BERT)"
    )


# model_config fields a payload may override for a checkpoint model: serving
# controls only (structural fields are the checkpoint's).
_CKPT_SERVING_OVERRIDES = ("dtype", "quant")


def _get_cfg(payload: Dict[str, Any], family: str, model_id: str):
    from agent_tpu_torch.models.layers import config_dtype
    from agent_tpu_torch.ops._model_common import apply_quant_env, config_from_payload

    if family in ("bart", "t5"):
        if family == "bart":
            from agent_tpu_torch.models.bart import BartConfig as config_cls
        else:
            from agent_tpu_torch.models.t5 import T5Config as config_cls

        overrides = payload.get("model_config")
        allowed = ({k: v for k, v in overrides.items() if k in _CKPT_SERVING_OVERRIDES}
                   if isinstance(overrides, dict) else {})
        cfg = config_cls.from_hf_json(os.path.join(model_id, "config.json"), **allowed)
    else:
        from agent_tpu_torch.models.seq2seq import Seq2SeqConfig

        cfg = config_from_payload(payload, Seq2SeqConfig)
    cfg = apply_quant_env(payload, cfg)
    config_dtype(cfg.dtype)  # the reference's error on a dtype it cannot serve
    return cfg


def _stage_chunks(texts: List[str], cfg, num_beams: int, family: str,
                  model_id: str, dp: int = 1) -> List[Tuple]:
    """Tokenize and pad into dispatch chunks whose rows divide ``dp``: the
    byte tokenizer with BOS and EOS for the in-house seq2seq, the
    checkpoint's byte-level BPE (``<s> pieces </s>``) for BART, its
    SentencePiece model (``pieces </s>``) for T5."""
    from agent_tpu_torch.ops._model_common import stage_text_chunks

    encode_pad = None
    if family == "bart":
        from agent_tpu_torch.models import bart

        tok = bart.hf_bpe(model_id)

        def encode_pad(chunk, lb, bb):
            return bart.encode_pad_batch(tok, chunk, cfg, bb, lb)

    elif family == "t5":
        from agent_tpu_torch.models import t5

        sp = t5.hf_spm(model_id)  # gated: actionable error without sentencepiece

        def encode_pad(chunk, lb, bb):
            return t5.encode_pad_batch(sp, chunk, cfg, bb, lb)

    return stage_text_chunks(dp, texts, max_len=cfg.max_src_len, vocab_size=cfg.vocab_size,
                             max_batch=max(1, MAX_DECODE_ROWS // num_beams),
                             add_bos=True, add_eos=True, encode_pad=encode_pad)


def _build_model(model_id: str, cfg, family: str, device):
    """One device's weights: BART's or T5's tree on ``device``, or a
    :class:`~agent_tpu_torch.models.seq2seq.Seq2Seq` (which the runtime
    moves there)."""
    if family == "bart":
        from agent_tpu_torch.models import bart

        return bart.load_hf_dir(model_id, device=device, dtype=cfg.dtype, quant=cfg.quant)[1]
    if family == "t5":
        from agent_tpu_torch.models import t5

        return t5.load_hf_dir(model_id, device=device, dtype=cfg.dtype, quant=cfg.quant)[1]
    from agent_tpu_torch.models import seq2seq

    return seq2seq.from_jax_params(_seq2seq_flat(model_id, cfg), cfg)


def _seq2seq_flat(model_id: str, cfg):
    """The seq2seq's f32 flat weights: a ``.npz`` over the seeded init, or
    the init of the model id."""
    from agent_tpu_torch.models import seq2seq

    if model_id.endswith(".npz") and os.path.exists(model_id):
        return seq2seq.load_npz(model_id, cfg)
    return seq2seq.init_params(cfg, model_id=model_id)


def _host_flat(model_id: str, cfg, family: str):
    """The served weights on the host as flat dotted keys, quantized for a
    quantized ``cfg.quant``: what a mesh places."""
    if family in ("bart", "t5"):
        from agent_tpu_torch.models import bart, t5

        module = bart if family == "bart" else t5
        return module.load_hf_flat(model_id, dtype=cfg.dtype, quant=cfg.quant)[1]
    from agent_tpu_torch.models import quant

    return quant.quantize_flat(_seq2seq_flat(model_id, cfg), "seq2seq", cfg.quant)[0]


def _get_model(runtime, model_id: str, cfg, family: str):
    """The served model on the runtime: placed over its mesh by the
    family's specs when it has dp or tp (a ``models.sharded_decoder``
    class), else on its device."""
    key = params_key(model_id, family, cfg)
    if not runtime.sharded:
        return runtime.get_params(key, lambda: _build_model(model_id, cfg, family,
                                                            runtime.device))
    from agent_tpu_torch.models import bart, seq2seq, t5
    from agent_tpu_torch.parallel import shardings

    cls = {"seq2seq": seq2seq.ShardedSeq2Seq, "t5": t5.ShardedT5, "bart": bart.ShardedBart}[family]
    return runtime.get_params(key, lambda: _host_flat(model_id, cfg, family),
                              specs=shardings.LAYOUT_SPECS[family](cfg),
                              place=lambda flat, specs, mesh: cls.place(flat, cfg, specs, mesh))


def params_key(model_id: str, family: str, cfg) -> str:
    """The runtime's weights-store key of a model: distinct configs never
    share weights."""
    from agent_tpu_torch.ops._model_common import cfg_key

    return f"{model_id}#{family}#{hash(cfg_key(cfg)) & 0xFFFFFFFF:08x}"


def _decode_chunks(runtime, chunks: List[Tuple], model_id: str, cfg, max_new: int,
                   num_beams: int, length_penalty: float = 1.0,
                   early_stopping: bool = False, min_length: int = 0,
                   family: str = "seq2seq") -> List[Tuple[torch.Tensor, int]]:
    """Device phase: decode staged ``(ids, lengths, n)`` chunks -> pending
    ``[(tokens on the device [B, max_new], n), ...]``."""
    from agent_tpu_torch.models import bart, seq2seq, t5

    model = _get_model(runtime, model_id, cfg, family)
    pending = []
    with torch.inference_mode():
        for ids, lengths, n in chunks:
            L = ids.shape[1]
            ids_t = runtime.put_batch(ids)
            n_t = runtime.put_batch(lengths)
            mask = (torch.arange(L, device=n_t.device)[None, :] < n_t[:, None]).to(torch.int32)
            if family == "bart":
                toks, _ = bart.generate(model, ids_t, mask, cfg, max_new, num_beams=num_beams,
                                        length_penalty=length_penalty,
                                        early_stopping=early_stopping, min_length=min_length,
                                        attn_fn=runtime.attention_fn())
            elif family == "t5":
                toks, _ = t5.generate(model, ids_t, mask, cfg, max_new, num_beams=num_beams,
                                      length_penalty=length_penalty,
                                      early_stopping=early_stopping, min_length=min_length,
                                      kernel=runtime.t5_attention_kernel())
            elif num_beams <= 1:
                toks, _ = seq2seq.greedy_generate(model, ids_t, mask, max_new,
                                                  min_length=min_length,
                                                  attn_fn=runtime.attention_fn())
            else:
                toks, _ = seq2seq.beam_generate(model, ids_t, mask, max_new,
                                                num_beams=num_beams,
                                                length_penalty=length_penalty,
                                                early_stopping=early_stopping,
                                                min_length=min_length,
                                                attn_fn=runtime.attention_fn())
            pending.append((toks, n))
    return pending


def stage(payload: Any, ctx: Optional[object] = None):
    """Host-only phase: validation and tokenize+pad. Returns ``("done",
    result)`` for soft errors or ``("staged", state)``."""
    from agent_tpu_torch.ops._model_common import (
        resolve_model_id,
        resolve_runtime,
        stage_divisor,
        validate_output_uri,
        validate_start_row,
    )

    t0 = time.perf_counter()
    if not isinstance(payload, dict):
        return "done", bad_input("payload must be a dict")
    texts = payload.get("texts")
    single = texts is None and "source_uri" not in payload
    empty_rows: List[int] = []  # drain-mode blank cells -> empty summaries
    if texts is None and "source_uri" in payload:
        from agent_tpu_torch.data.csv_index import read_shard_texts

        try:
            texts = read_shard_texts(payload)
        except ValueError as exc:
            return "done", bad_input(str(exc))
        # A blank cell gets an empty summary (set after generation) instead
        # of failing the shard or emitting model output for no input; the
        # payload 'texts' path keeps its strict non-empty contract.
        empty_rows = [i for i, t in enumerate(texts) if not t]
        if empty_rows:
            texts = [t or " " for t in texts]
    elif single:
        text = payload.get("text")
        if not isinstance(text, str) or not text:
            return "done", bad_input("payload requires a non-empty 'text' string")
        texts = [text]
    elif not isinstance(texts, list) or not texts or not all(
            isinstance(t, str) and t for t in texts):
        return "done", bad_input("texts must be a non-empty list of non-empty strings")

    max_new = payload.get("max_length", DEFAULT_MAX_LENGTH)
    if isinstance(max_new, bool) or not isinstance(max_new, int) or max_new <= 0:
        return "done", bad_input("max_length must be a positive int")
    num_beams = payload.get("num_beams", 1)
    if isinstance(num_beams, bool) or not isinstance(num_beams, int) or \
            not 1 <= num_beams <= 16:
        return "done", bad_input("num_beams must be an int in [1, 16]")
    length_penalty = payload.get("length_penalty", 1.0)
    if isinstance(length_penalty, bool) or not isinstance(length_penalty, (int, float)) \
            or not -4.0 <= float(length_penalty) <= 4.0:
        return "done", bad_input("length_penalty must be a number in [-4, 4]")
    early_stopping = payload.get("early_stopping", False)
    if not isinstance(early_stopping, bool):
        return "done", bad_input("early_stopping must be a bool")
    # HF counting: min_length bounds the full decoder sequence (start +
    # generated).
    min_length = payload.get("min_length", 0)
    if isinstance(min_length, bool) or not isinstance(min_length, int) or min_length < 0:
        return "done", bad_input("min_length must be a non-negative int")
    try:
        output_dir = validate_output_uri(payload)
        start_row = validate_start_row(payload)
    except ValueError as exc:
        return "done", bad_input(str(exc))

    model_id = resolve_model_id(payload, "BART_MODEL", DEFAULT_MODEL_ID)
    # Checkpoint-integrity problems raise past the soft-error handlers on
    # purpose: a retryable failure, not bad input.
    family = _resolve_family(model_id)
    force_cpu = os.environ.get("SUMMARIZE_FORCE_CPU", "").strip().lower() in _TRUTHY
    try:
        cfg = _get_cfg(payload, family, model_id)
        # The batch divides the executing mesh's dp (the reference's
        # resolve_dp); the forced CPU runtime is one device.
        dp = 1 if force_cpu else stage_divisor(resolve_runtime(ctx), cfg, family)
    except ValueError as exc:
        return "done", bad_input(str(exc))

    state = {
        "t0": t0,
        "chunks": _stage_chunks(texts, cfg, num_beams, family, model_id, dp),
        "single": single,
        "empty_rows": empty_rows,
        "max_new": min(max_new, cfg.max_tgt_len),
        "num_beams": num_beams,
        "length_penalty": float(length_penalty),
        "early_stopping": early_stopping,
        "min_length": min_length,
        "model_id": model_id,
        "family": family,
        "cfg": cfg,
        "force_cpu": force_cpu,
        "output_dir": output_dir,
        "start_row": start_row,
        "t_staged": time.perf_counter(),
    }
    return "staged", state


def _stamp_flops(state: Dict[str, Any], ctx: Optional[object]) -> None:
    """Analytic matmul FLOPs of encode + incremental decode of the staged
    chunks into ``ctx.tags``."""
    from agent_tpu_torch.ops._model_common import seq2seq_fwd_flops, stamp_device_flops

    cfg = state["cfg"]
    total, biggest = 0.0, (0, "?")
    for ids, _, _ in state["chunks"]:
        B, L = ids.shape
        total += seq2seq_fwd_flops(B, L, state["max_new"], cfg.d_model, cfg.d_ff,
                                   cfg.n_enc_layers, cfg.n_dec_layers,
                                   vocab_size=cfg.vocab_size, num_beams=state["num_beams"])
        if B * L > biggest[0]:
            biggest = (B * L, f"B{B}xL{L}xT{state['max_new']}")
    stamp_device_flops(ctx, total, biggest[1])


def execute(state: Dict[str, Any], ctx: Optional[object] = None) -> Dict[str, Any]:
    """Device phase: decode the staged chunks and leave the tokens on the
    device; finalize pays the fetch. A device failure raises here or there
    and fails the request (no CPU retry)."""
    state["t_exec0"] = time.perf_counter()
    _stamp_flops(state, ctx)
    if state["force_cpu"]:
        runtime = _get_cpu_runtime()
    else:
        from agent_tpu_torch.ops._model_common import device_runtime

        runtime = device_runtime(ctx, "map_summarize")
    from agent_tpu_torch.runtime.runtime import HostCopy

    # The tokens' copies to the host are queued here; finalize waits for
    # them alone (HostCopy), not for the work queued after them.
    state["token_chunks"] = [(HostCopy(toks), n) for toks, n in _decode_chunks(
        runtime, state["chunks"], state["model_id"], state["cfg"], state["max_new"],
        state["num_beams"], length_penalty=state["length_penalty"],
        early_stopping=state["early_stopping"], min_length=state["min_length"],
        family=state["family"])]
    state["device"] = runtime.platform
    state["t_device"] = time.perf_counter()
    return state


def finalize(state: Dict[str, Any], ctx: Optional[object] = None) -> Dict[str, Any]:
    """Host phase: fetch the token rows, detokenize, write the sink, shape
    the result."""
    from agent_tpu_torch.ops._model_common import stamp_rows, write_output_shard

    t_f = time.perf_counter()
    token_chunks = [toks.numpy()[:n] for toks, n in state["token_chunks"]]
    fetch_ms = (time.perf_counter() - t_f) * 1000.0
    summaries: List[str] = []
    if state["family"] == "bart":
        from agent_tpu_torch.models import bart

        cfg = state["cfg"]
        tok = bart.hf_bpe(state["model_id"])
        # The id set transformers' skip_special_tokens drops, <unk> included.
        skip = {cfg.pad_id, cfg.bos_id, cfg.eos_id, cfg.decoder_start_id}
        unk = tok.vocab.get("<unk>")
        if unk is not None:
            skip.add(unk)
        for toks in token_chunks:
            summaries.extend(tok.decode([t for t in row if int(t) not in skip]).strip()
                             for row in toks)
    elif state["family"] == "t5":
        from agent_tpu_torch.models import t5

        cfg = state["cfg"]
        sp = t5.hf_spm(state["model_id"])
        n_pieces = sp.GetPieceSize()
        # The id set transformers' skip_special_tokens drops, unk included.
        skip = {cfg.pad_id, cfg.eos_id, sp.unk_id()}
        for toks in token_chunks:
            summaries.extend(
                sp.DecodeIds([int(t) for t in row if int(t) not in skip and int(t) < n_pieces]
                             ).strip()
                for row in toks)
    else:
        from agent_tpu_torch.models.tokenizer import ByteTokenizer

        tok = ByteTokenizer()
        for toks in token_chunks:
            summaries.extend(tok.decode([t for t in row if t > 0]) for row in toks)
    for i in state["empty_rows"]:
        summaries[i] = ""  # no input -> no summary, not model noise

    if ctx is not None and hasattr(ctx, "tags"):
        ctx.tags.setdefault("timings", {}).update(
            stage_ms=round((state["t_staged"] - state["t0"]) * 1000.0, 3),
            queue_ms=round((state["t_exec0"] - state["t_staged"]) * 1000.0, 3),
            device_ms=round((state["t_device"] - state["t_exec0"]) * 1000.0, 3),
            fetch_ms=round(fetch_ms, 3),
        )
    stamp_rows(ctx, len(summaries))
    out: Dict[str, Any] = {
        "ok": True,
        "op": "map_summarize",
        "device": state["device"],
        "model": state["model_id"],
        "num_beams": state["num_beams"],
        "elapsed_ms": (time.perf_counter() - state["t0"]) * 1000.0,
    }
    if state["output_dir"] is not None:
        path, n = write_output_shard(state["output_dir"], "map_summarize", state["start_row"],
                                     ({"summary": s} for s in summaries))
        out["output_path"] = path
        out["rows_written"] = n
        return out
    out["summary"] = summaries[0]
    if not state["single"]:
        if ctx is not None and hasattr(ctx, "tags") and ctx.tags.get("wire") == "b1":
            # The negotiated binary wire: the summaries column ships
            # length-prefixed (and deflated when that is smaller) and decodes
            # to the identical list.
            from agent_tpu_torch.data import wire

            return wire.attach_result_columns(out, {"summaries": summaries})
        out["summaries"] = summaries
    return out


@register_op("map_summarize")
def run(payload: Any, ctx: Optional[object] = None) -> Dict[str, Any]:
    """Monolithic entry: stage -> execute -> finalize inline."""
    phase, value = stage(payload, ctx)
    if phase == "done":
        return value
    return finalize(execute(value, ctx), ctx)


# Phase hooks for a pipelined caller.
run.stage = stage
run.execute = execute
run.finalize = finalize
