"""Text classification on the card — counterpart of
``agent_tpu.ops.map_classify_tpu`` with the same op name, phases, payload
and result contract.

- Payload: ``input`` (flat token ids), ``text`` or ``texts``, or CSV shard
  addressing (``source_uri`` + ``start_row``/``shard_size`` + optional
  ``text_field``, read with ``data.csv_index.read_shard_texts``), plus
  ``topk`` (default 5), ``model_path``, ``model_config``, ``result_format``
  (``rows`` | ``columnar``), ``output_uri`` / ``start_row`` and
  ``allow_fallback``.
- Result: ``{ok, op, model_path, device, n_rows, elapsed_ms, topk}`` (plus
  ``results`` per row for ``texts``, or ``indices``/``scores`` columns —
  as a ``b1`` blob when the agent negotiated the binary wire — or an
  ``output_path`` receipt); caller errors come back as soft ``bad_input``
  results. A shard that cannot be read, or lacks its column, raises, so the
  task fails and the controller retries it.
- ``allow_fallback`` is accepted and has no effect: unlike the reference,
  the port never retries a request on the CPU. A failure on the card (a
  kernel that does not build or launch, a lost device) raises and fails the
  request; the CPU runs only when the caller's runtime is a CPU one.

Rows batch into bucketed shapes, and the forward for each (model, batch,
length, k, config) is built once per runtime. Top-k runs on the device;
execute queues the copy of one packed ``[B, k, 2]`` array per request to
the host (``runtime.HostCopy``), and finalize waits for that copy alone, so
in the agent's pipeline the poster thread does not wait for the next
shard's forward.

Families, resolved from ``model_path`` as the reference does: a local HF
checkpoint directory (``config.json``) serves the pretrained BERT family
(:mod:`agent_tpu_torch.models.bert`: weights from ``model.safetensors`` or
``pytorch_model.bin``, text through the checkpoint's ``vocab.txt``, and
``model_config`` may override only ``dtype``, ``num_labels`` and
``quant``); anything else serves the in-house encoder (seeded weights from
the model id, or a ``.npz``). A checkpoint whose ``config.json`` does not
read, or is not BERT's, raises: a retryable integrity failure, not bad
input.

On a mesh (``runtime.sharded``: dp, tp, pp or ep above 1) the weights are
placed by the family's specs (``runtime.get_params(specs=)``: a
``ShardedEncoder``, ``PipelinedEncoder`` or ``ShardedBert``), batches
stage to a multiple of dp (of pp · dp on a pp mesh, of every device for a
``model_config`` pp), and each shard launches the attention kernel with its
rows and heads. A ``pp`` axis, or ``model_config {"pp": N}`` over a dp × pp
mesh of the runtime's devices, sends the encoder through the GPipe
pipeline, with the reference's guards (soft ``bad_input``): a depth that
pp does not divide, MoE with pp, and a pp that does not divide the
devices. With ``sp`` > 1 every layer attends through ring attention, in
each (dp, tp) group. The forward cache belongs to the runtime, whose mesh
and attention function are fixed, so its keys need no mesh.

Strategies of the reference's ``model_config``: ``quant`` (``int8`` W8A8
or ``w8a16`` weight only; from the payload, else ``TPU_QUANT``, else the
config) serves either family's block matmuls quantized
(:mod:`agent_tpu_torch.models.quant`, the tables made on the host from the
f32 weights); ``moe_experts`` > 0 gives the in-house encoder Switch MoE FFNs
(:mod:`agent_tpu_torch.models.moe`), quantized too when ``quant`` asks.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from agent_tpu_torch.ops import register_op
from agent_tpu_torch.utils.errors import bad_input

DEFAULT_TOPK = 5
DEFAULT_MODEL_ID = "classify-default"
MAX_BATCH = 8192


def _get_cfg(payload: Dict[str, Any]):
    from agent_tpu_torch.models.encoder import EncoderConfig
    from agent_tpu_torch.models.layers import config_dtype
    from agent_tpu_torch.ops._model_common import apply_quant_env, config_from_payload

    cfg = apply_quant_env(payload, config_from_payload(payload, EncoderConfig))
    config_dtype(cfg.dtype)  # the reference's error on a dtype it cannot serve
    return cfg


def _resolve_family(model_id: str) -> str:
    """``"bert"`` for a local HF checkpoint directory, else ``"encoder"``."""
    from agent_tpu_torch.models import bert

    return "bert" if bert.is_hf_dir(model_id) else "encoder"


# The model_config fields a payload may override for a checkpoint: serving
# controls only (the structural fields are the checkpoint's).
_BERT_SERVING_OVERRIDES = ("dtype", "num_labels", "quant")


def _get_bert_cfg(model_id: str, payload: Dict[str, Any]):
    """BertConfig from the checkpoint's config.json with the payload's
    serving overrides (``_BERT_SERVING_OVERRIDES``)."""
    from agent_tpu_torch.models.bert import BertConfig
    from agent_tpu_torch.models.layers import config_dtype
    from agent_tpu_torch.ops._model_common import apply_quant_env

    overrides = payload.get("model_config")
    allowed = ({k: v for k, v in overrides.items() if k in _BERT_SERVING_OVERRIDES}
               if isinstance(overrides, dict) else {})
    cfg = apply_quant_env(payload, BertConfig.from_hf_json(
        os.path.join(model_id, "config.json"), **allowed))
    config_dtype(cfg.dtype)  # the reference's error on a dtype it cannot serve
    return cfg


def _collect_sequences(payload: Dict[str, Any], cfg) -> Tuple[List, str, bool]:
    """Payload -> (items, kind, was_single_input); kind ``"ids"`` (token-id
    lists) or ``"texts"``. Precedence: ``input``, then ``texts``, then
    ``text``, then ``source_uri``. A malformed shard address raises
    ValueError (a soft ``bad_input``); an unreadable shard raises
    RuntimeError or OSError (the task fails)."""
    if "input" in payload:
        raw = payload["input"]
        if not isinstance(raw, list) or not raw:
            raise ValueError("input must be a non-empty flat list of ints")
        ids = []
        for v in raw:
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                raise ValueError("input values must be numeric")
            iv = int(v)
            if not 0 <= iv < cfg.vocab_size:
                raise ValueError(f"input id {iv} out of range [0, {cfg.vocab_size})")
            ids.append(iv)
        return [ids[: cfg.max_len]], "ids", True
    texts = payload.get("texts")
    single = False
    if texts is None and "text" in payload:
        texts = [payload["text"]]
        single = True
    if texts is None and "source_uri" in payload:
        from agent_tpu_torch.data.csv_index import read_shard_texts

        texts = read_shard_texts(payload)
    if texts is not None:
        if not isinstance(texts, list) or not texts or not all(
            isinstance(t, str) for t in texts
        ):
            raise ValueError("texts must be a non-empty list of strings")
        return texts, "texts", single
    raise ValueError(
        "payload requires 'input' (token ids), 'text'/'texts', or "
        "'source_uri' CSV shard addressing"
    )


def _dims(cfg) -> Tuple[int, int, int, int]:
    """(d_model, d_ff, n_layers, n_heads) of either family's config."""
    if hasattr(cfg, "hidden_size"):
        return cfg.hidden_size, cfg.intermediate_size, cfg.num_layers, cfg.num_heads
    return cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.n_heads


def _check_pp(cfg, rt) -> None:
    """The reference's guards on the pipeline (ValueError, a soft
    ``bad_input``): the effective pp is the mesh's pp axis, else the
    config's."""
    mesh_pp = rt.axis_size("pp") if rt is not None else 1
    pp = mesh_pp if mesh_pp > 1 else cfg.pp
    if pp <= 1:
        return
    if cfg.n_layers % pp:
        raise ValueError(f"n_layers {cfg.n_layers} not divisible by pp={pp}")
    if cfg.moe_experts > 0:
        raise ValueError("pp and moe_experts cannot combine in one config")
    n_dev = rt.n_devices if rt is not None else 1
    if mesh_pp <= 1 and n_dev % pp:
        raise ValueError(f"pp={pp} does not divide the {n_dev}-device mesh")


def _stage_chunks(items: List, kind: str, cfg, family: str = "encoder",
                  model_id: str = "", dp: int = 1) -> List[Tuple]:
    """Pure host: tokenize and pad ``items`` into dispatch chunks
    ``[(ids[B, L], lengths[B] int32, n_real_rows), ...]``, batch buckets
    ``dp``, 2·dp, .... Texts go through the fused byte path for the
    in-house encoder and the checkpoint's wordpiece vocab (``[CLS] pieces
    [SEP]``) for BERT."""
    from agent_tpu_torch.models.tokenizer import pad_batch
    from agent_tpu_torch.ops._model_common import (
        batch_buckets,
        iter_chunks,
        length_buckets_for,
        split_padded_chunk,
        stage_text_chunks,
    )

    d_model, _, _, n_heads = _dims(cfg)
    d_head, dtype = d_model // n_heads, cfg.compute_dtype
    if kind == "texts":
        encode_pad = None
        if family == "bert":
            from agent_tpu_torch.models import bert

            tok = bert.hf_wordpiece(model_id)

            def encode_pad(chunk, lb, bb):
                return bert.encode_pad_batch(tok, chunk, cfg.max_len, bb, lb)

        return stage_text_chunks(dp, items, max_len=cfg.max_len, vocab_size=cfg.vocab_size,
                                 max_batch=MAX_BATCH, d_head=d_head, dtype=dtype,
                                 encode_pad=encode_pad)
    buckets = length_buckets_for(cfg.max_len)
    bbuckets = batch_buckets(dp, MAX_BATCH)
    chunks: List[Tuple] = []
    for chunk in iter_chunks(items, bbuckets[-1]):
        ids, _ = pad_batch(chunk, buckets=buckets, batch_buckets=bbuckets)
        lengths = np.zeros(ids.shape[0], dtype=np.int32)
        lengths[: len(chunk)] = [min(len(s), ids.shape[1]) for s in chunk]
        chunks.extend(split_padded_chunk(ids, lengths, len(chunk), dp, d_head, dtype))
    return chunks


def _build_model(model_id: str, cfg, family: str = "encoder", device=None):
    """The served weights: BERT's parameter tree on ``device``, or an
    :class:`~agent_tpu_torch.models.encoder.Encoder` (which the runtime
    moves there)."""
    if family == "bert":
        from agent_tpu_torch.models import bert

        # The staged config's overrides, so the head matches num_labels.
        return bert.load_hf_dir(model_id, device=device, dtype=cfg.dtype,
                                num_labels=cfg.num_labels, quant=cfg.quant)[1]
    from agent_tpu_torch.models import encoder

    return encoder.from_jax_params(_host_flat(model_id, cfg, family), cfg)


def _host_flat(model_id: str, cfg, family: str):
    """The served weights on the host as flat dotted-key arrays, quantized
    for a quantized ``cfg.quant``: what a mesh places."""
    if family == "bert":
        from agent_tpu_torch.models import bert

        return bert.load_hf_flat(model_id, dtype=cfg.dtype, num_labels=cfg.num_labels,
                                 quant=cfg.quant)[1]
    from agent_tpu_torch.models import encoder, quant

    if model_id.endswith(".npz") and os.path.exists(model_id):
        flat = encoder.load_npz(model_id, cfg)
    else:
        flat = encoder.init_params(cfg, model_id=model_id)
    return quant.quantize_flat(flat, "encoder", cfg.quant)[0]


def _get_model(runtime, model_id: str, cfg, family: str, host=None):
    """The served model on the runtime: placed over its mesh by the
    family's specs when it has one (from ``host()``'s flat arrays when
    given, else :func:`_host_flat`'s), else on its device."""
    key = params_key(model_id, family, cfg)
    pp_route = family == "encoder" and runtime.axis_size("pp") <= 1 and cfg.pp > 1
    if not (runtime.sharded or pp_route):
        return runtime.get_params(key, lambda: _build_model(model_id, cfg, family,
                                                            runtime.device))
    from agent_tpu_torch.parallel import shardings

    if family == "bert":
        from agent_tpu_torch.models.bert import ShardedBert

        def place(flat, specs, mesh):
            return ShardedBert(flat, cfg, specs, mesh)
    elif pp_route:
        from agent_tpu_torch.parallel.pipeline import PipelinedEncoder
        from agent_tpu_torch.runtime.mesh import build_mesh

        # The reference's derived mesh: the same devices as dp × pp.
        pp_mesh = build_mesh(runtime.devices, {"dp": runtime.n_devices // cfg.pp,
                                               "pp": cfg.pp})

        def place(flat, specs, mesh):
            return PipelinedEncoder(flat, cfg, pp_mesh)
    else:
        from agent_tpu_torch.models import encoder

        def place(flat, specs, mesh):
            return encoder.place(flat, specs, mesh, cfg)
    return runtime.get_params(key, host or (lambda: _host_flat(model_id, cfg, family)),
                              specs=shardings.FAMILY_SPECS[family](cfg), place=place)


def params_key(model_id: str, family: str, cfg) -> str:
    """The runtime's weights-store key of a model: distinct configs (a quant
    mode included) never share weights."""
    from agent_tpu_torch.ops._model_common import cfg_key

    return f"{model_id}#{family}#{hash(cfg_key(cfg)) & 0xFFFFFFFF:08x}"


def _make_forward(L: int, k: int, attn_fn, family: str = "encoder", cfg=None):
    """The forward for one (batch, length, k) shape: rebuild ids and mask
    from the wire on the device, run the model (the in-house encoder, or
    BERT's forward over its parameter tree), and pack the top-k values and
    indices (int32 bit patterns as f32) into one ``[B, k, 2]`` tensor, so
    the host fetches one array."""
    from agent_tpu_torch.models import bert
    from agent_tpu_torch.models.encoder import topk_probs
    from agent_tpu_torch.models.tokenizer import N_SPECIAL

    def run_fwd(model, wire: torch.Tensor, nlen: torch.Tensor) -> torch.Tensor:
        mask = (torch.arange(L, device=wire.device)[None, :] < nlen[:, None]).to(torch.int32)
        ids = wire.to(torch.int32)
        if wire.dtype == torch.uint8:
            ids = (ids + N_SPECIAL) * mask  # raw-byte wire (stage_text_chunks)
        logits = (bert.forward(model, ids, mask, cfg, attn_fn) if family == "bert"
                  else model(ids, mask, attn_fn))
        vals, idx = topk_probs(logits, k)
        return torch.stack([vals, idx.to(torch.int32).view(torch.float32)], dim=-1)

    return run_fwd


def _execute_chunks(runtime, chunks: List[Tuple], model_id: str, cfg, k: int,
                    family: str = "encoder"):
    """Device phase -> the pending result, its copy to the host queued
    (``HostCopy``) and waited for by finalize: one ``(packed, n)`` entry, or
    ``("cat", packed, layout)`` when several dispatch chunks were
    concatenated on the device."""
    from agent_tpu_torch.ops._model_common import cfg_key
    from agent_tpu_torch.runtime.runtime import HostCopy

    model = _get_model(runtime, model_id, cfg, family)
    attn_fn = runtime.attention_fn()
    pending: List[Tuple[Any, int]] = []
    with torch.inference_mode():
        for ids, lengths, n in chunks:
            B, L = ids.shape
            fn = runtime.compiled(
                ("map_classify_tpu", model_id, family, B, L, k, cfg_key(cfg)),
                lambda L=L: _make_forward(L, k, attn_fn, family, cfg),
            )
            pending.append((fn(model, runtime.put_batch(ids),
                               runtime.put_batch(lengths)), n))
        if len(pending) > 1:
            packed = torch.cat([p for p, _ in pending], dim=0)
            return [("cat", HostCopy(packed), [(p.shape[0], n) for p, n in pending])]
    return [(HostCopy(packed), n) for packed, n in pending]


def _fetch_pending(pending) -> Tuple[np.ndarray, np.ndarray]:
    """Pending device result -> (vals [N, k] f32, idx [N, k] int32) numpy,
    padding rows dropped; one device-to-host copy."""
    first = pending[0]
    if isinstance(first[0], str):  # ("cat", packed, layout)
        _, packed, layout = first
        arr = packed.numpy()
        parts, off = [], 0
        for B, n in layout:
            parts.append(arr[off:off + n])
            off += B
        arr = np.concatenate(parts)
    else:
        packed, n = first
        arr = packed.numpy()[:n]
    vals = np.ascontiguousarray(arr[..., 0])
    idx = np.ascontiguousarray(arr[..., 1]).view(np.int32)
    return vals, idx


def stage(payload: Any, ctx: Optional[object] = None):
    """Host-only phase: ``("done", result)`` for an immediate soft result,
    else ``("staged", state)`` for :func:`execute`. Touches no device."""
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
    topk = payload.get("topk", DEFAULT_TOPK)
    if isinstance(topk, bool) or not isinstance(topk, int) or topk <= 0:
        return "done", bad_input("topk must be a positive int")
    result_format = payload.get("result_format", "rows")
    if result_format not in ("rows", "columnar"):
        return "done", bad_input("result_format must be 'rows' or 'columnar'")
    model_id = resolve_model_id(payload, "TPU_MODEL_PATH", DEFAULT_MODEL_ID)
    family = _resolve_family(model_id)
    rt = resolve_runtime(ctx)  # one resolution serves the guards and the staging
    try:
        # A checkpoint's integrity problems (config.json unreadable, not
        # BERT's, lacking a field) raise past this handler on purpose: the
        # shard fails for a retry instead of being dropped as bad input.
        cfg = _get_bert_cfg(model_id, payload) if family == "bert" else _get_cfg(payload)
        if family == "encoder":
            _check_pp(cfg, rt)
        items, kind, single = _collect_sequences(payload, cfg)
        output_dir = validate_output_uri(payload)
        start_row = validate_start_row(payload)
    except ValueError as exc:
        return "done", bad_input(str(exc))

    state = {
        "t0": t0,
        "chunks": _stage_chunks(items, kind, cfg, family, model_id,
                                stage_divisor(rt, cfg, family)),
        "n_rows": len(items),
        "cfg": cfg,
        "k": min(topk, cfg.n_classes),
        "model_id": model_id,
        "family": family,
        "result_format": result_format,
        "single": single,
        "output_dir": output_dir,
        "start_row": start_row,
        "t_staged": time.perf_counter(),
    }
    return "staged", state


def _stamp_flops(state: Dict[str, Any], ctx: Optional[object]) -> None:
    """Analytic matmul FLOPs of the staged chunks into ``ctx.tags``."""
    from agent_tpu_torch.ops._model_common import encoder_fwd_flops, stamp_device_flops

    cfg = state["cfg"]
    d_model, d_ff, n_layers, _ = _dims(cfg)
    total, biggest = 0.0, (0, "?")
    for ids, _, _ in state["chunks"]:
        B, L = ids.shape
        total += encoder_fwd_flops(B, L, d_model, d_ff, n_layers, cfg.n_classes)
        if B * L > biggest[0]:
            biggest = (B * L, f"B{B}xL{L}")
    stamp_device_flops(ctx, total, biggest[1])


def execute(state: Dict[str, Any], ctx: Optional[object] = None) -> Dict[str, Any]:
    """Device phase: dispatch the staged chunks and leave the result on the
    device; finalize pays the fetch. A device failure raises here or there
    and fails the request (no CPU retry)."""
    state["t_exec0"] = time.perf_counter()
    _stamp_flops(state, ctx)
    from agent_tpu_torch.ops._model_common import device_runtime

    runtime = device_runtime(ctx, "map_classify_tpu")
    state.update(
        pending_dev=_execute_chunks(runtime, state["chunks"], state["model_id"],
                                    state["cfg"], state["k"], state["family"]),
        device=runtime.platform,
        t_device=time.perf_counter(),
    )
    return state


def finalize(state: Dict[str, Any], ctx: Optional[object] = None) -> Dict[str, Any]:
    """Host phase: top-k arrays -> the JSON-shaped result."""
    from agent_tpu_torch.models.encoder import topk_rows
    from agent_tpu_torch.ops._model_common import stamp_rows, write_output_shard

    t0, model_id = state["t0"], state["model_id"]
    result_format = state["result_format"]
    t_f = time.perf_counter()
    vals, idx = _fetch_pending(state["pending_dev"])
    fetch_ms = (time.perf_counter() - t_f) * 1000.0

    if ctx is not None and hasattr(ctx, "tags"):
        ctx.tags.setdefault("timings", {}).update(
            stage_ms=round((state["t_staged"] - t0) * 1000.0, 3),
            queue_ms=round((state["t_exec0"] - state["t_staged"]) * 1000.0, 3),
            device_ms=round((state["t_device"] - state["t_exec0"]) * 1000.0, 3),
            fetch_ms=round(fetch_ms, 3),
        )
    stamp_rows(ctx, state["n_rows"])
    out: Dict[str, Any] = {
        "ok": True,
        "op": "map_classify_tpu",
        "model_path": model_id,
        "device": state["device"],
        "n_rows": state["n_rows"],
        "elapsed_ms": (time.perf_counter() - t0) * 1000.0,
    }
    if state["output_dir"] is not None:
        idx_l = np.asarray(idx).tolist()
        val_l = np.round(np.asarray(vals), 6).tolist()
        path, n = write_output_shard(
            state["output_dir"], "map_classify_tpu", state["start_row"],
            ({"indices": i, "scores": s} for i, s in zip(idx_l, val_l)),
        )
        out["output_path"] = path
        out["rows_written"] = n
        return out

    if result_format == "columnar":
        if ctx is not None and hasattr(ctx, "tags") and ctx.tags.get("wire") == "b1":
            # The negotiated binary wire: the [N, k] columns ship as raw
            # arrays (indices width-shrunk, scores as the rounded f32 bit
            # patterns) and decode to exactly the JSON path's lists.
            from agent_tpu_torch.data import wire

            return wire.attach_result_columns(out, {
                "indices": np.ascontiguousarray(idx),
                "scores": np.round(np.asarray(vals), 6),
            })
        out["indices"] = np.asarray(idx).tolist()
        out["scores"] = np.round(np.asarray(vals), 6).tolist()
        return out

    per_row = topk_rows(vals, idx)
    out["topk"] = per_row[0]
    if not state["single"]:
        out["results"] = [{"topk": t} for t in per_row]
    return out


@register_op("map_classify_tpu")
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
