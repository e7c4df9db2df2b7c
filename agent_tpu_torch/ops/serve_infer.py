"""Request-serving ops on the card, the agent's half of the reference's
``POST /v1/infer`` path — counterpart of ``agent_tpu.ops.serve_infer`` with
the same op names, payloads, result shapes, soft errors and telemetry.

The controller's front door coalesces single requests into length-bucketed
batch jobs (``{"requests": [{req_id, text, arrived_wall?, max_length?}],
"bucket", ...decode params}``); these ops execute them:

- ``serve_classify``: one batched encoder forward through the port's
  ``map_classify_tpu`` (columnar, its ``b1`` tag taken off for the call),
  fanned back out per request.
- ``serve_summarize``: prefill then continuous decode. The prefill is one
  batched ``seq2seq.encode`` of the rows that missed the prefix cache,
  through the runtime's attention function (the flash kernel on the card),
  handing over f32 rows; the requests then join a process-persistent
  :class:`~agent_tpu_torch.models.decoding.ContinuousBatcher` whose running
  batch decodes ``SERVE_DECODE_SLOTS`` requests × ``num_beams`` beam rows a
  step, each with its own ``max_length`` as its token limit.
- ``serve_prefill`` / ``serve_decode``: the same split across two jobs
  (``SERVE_DISAGG``): the prefill's encoded rows are its result (``b1``
  columns when the wire was negotiated, JSON floats otherwise; both give
  the same f32 rows), and the decode job resumes from them (``encoded``, or
  the controller's dep-gated ``partials``) without running the encoder.

Phases for the pipelined drain: ``stage``/``execute``/``finalize``, plus
the serving hooks its continuous loop drives: ``serve_admit`` (prefill and
join), ``serve_pump`` (one engine step), ``serve_done``, ``serve_collect``.
The monolithic call pumps to completion inline. The weights are
``map_summarize``'s, under the same key, so serving and the batch op share
one copy on the card. These ops serve the in-house seq2seq family only: a
checkpoint directory stays on ``map_summarize``. ``model_config {"quant":
"int8" | "w8a16"}`` serves the seq2seq quantized (its weights, key and
prefix-cache entries are the quantized model's own). A failure on the card
raises and fails the request; nothing retries on the CPU.

On a mesh with ``dp`` or ``tp`` the weights are ``map_summarize``'s sharded
seq2seq (``models.seq2seq.ShardedSeq2Seq``): the prefill's encoder runs
over the shards, and the engine on replica 0's tp group, each tp shard's KV
cache (dense rows, or a paged pool under the one block table) holding its
heads. The other replicas hold the same weights and run none of the engine,
as in the reference, whose engine puts nothing on dp. The prefix cache
keeps host f32 encoder rows, whatever the mesh.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from agent_tpu_torch.ops import register_op
from agent_tpu_torch.ops._model_common import device_runtime, resolve_runtime, stage_divisor
from agent_tpu_torch.utils.errors import bad_input

# Process-wide engine store, keyed by runtime and model/config/shape
# signature. Only the device thread creates and steps engines (inside the
# ops' execute paths), so no lock.
_ENGINES: Dict[Tuple, Any] = {}

# Process-wide prefix cache, rebuilt when its knobs change.
_PREFIX_CACHE: Any = None
_PREFIX_KNOBS: Optional[Tuple] = None


def reset_engines() -> None:
    """Drop every cached engine and the prefix cache (tests; a fresh
    runtime invalidates them)."""
    global _PREFIX_CACHE, _PREFIX_KNOBS
    _ENGINES.clear()
    _PREFIX_CACHE = None
    _PREFIX_KNOBS = None


def _get_prefix_cache(serve):
    """The process prefix cache for the active knobs, or None when off."""
    global _PREFIX_CACHE, _PREFIX_KNOBS
    if not serve.prefix_cache_enabled or serve.prefix_cache_entries < 1 \
            or serve.prefix_cache_mb <= 0:
        return None
    knobs = (serve.prefix_cache_entries, serve.prefix_cache_mb)
    if _PREFIX_CACHE is None or _PREFIX_KNOBS != knobs:
        from agent_tpu_torch.ops.prefix_cache import PrefixCache

        _PREFIX_CACHE = PrefixCache(max_entries=serve.prefix_cache_entries,
                                    max_bytes=int(serve.prefix_cache_mb * 2 ** 20))
        _PREFIX_KNOBS = knobs
    return _PREFIX_CACHE


def _clamp_ttft(first_wall: Optional[float], arrived: Any) -> Optional[float]:
    """First-token wall minus the controller's arrival wall, in ms, clamped
    at 0 (two hosts' clocks)."""
    if first_wall is None or not isinstance(arrived, (int, float)):
        return None
    return round(max(0.0, (first_wall - float(arrived)) * 1e3), 3)


def _validate_requests(payload: Dict[str, Any]):
    reqs = payload.get("requests")
    if not isinstance(reqs, list) or not reqs:
        raise ValueError("payload requires a non-empty 'requests' list")
    for r in reqs:
        if not (isinstance(r, dict)
                and isinstance(r.get("req_id"), str) and r["req_id"]
                and isinstance(r.get("text"), str) and r["text"]):
            raise ValueError("each request needs a string req_id and a non-empty text")
    return reqs


# ---------------------------------------------------------------------------
# serve_classify
# ---------------------------------------------------------------------------

@register_op("serve_classify")
def run_classify(payload: Any, ctx: Optional[object] = None) -> Dict[str, Any]:
    """Batched interactive classify: requests in, per-request top-k out."""
    t0 = time.perf_counter()
    t0_wall = time.time()
    if not isinstance(payload, dict):
        return bad_input("payload must be a dict")
    try:
        reqs = _validate_requests(payload)
    except ValueError as exc:
        return bad_input(str(exc))
    topk = payload.get("topk", 1)
    if isinstance(topk, bool) or not isinstance(topk, int) or topk < 1:
        return bad_input("topk must be a positive int")

    from agent_tpu_torch.ops import get_op

    sub: Dict[str, Any] = {"texts": [r["text"] for r in reqs], "topk": topk,
                           "allow_fallback": False, "result_format": "columnar"}
    if isinstance(payload.get("model_config"), dict):
        sub["model_config"] = payload["model_config"]
    # The b1 tag would make classify emit deflated columns; this op fans
    # them out per request, so it takes the tag off for the call.
    tags = getattr(ctx, "tags", None) if ctx is not None else None
    wire_fmt = tags.pop("wire", None) if isinstance(tags, dict) else None
    try:
        out = get_op("map_classify_tpu")(sub, ctx)
    finally:
        if wire_fmt is not None:
            tags["wire"] = wire_fmt
    if not (isinstance(out, dict) and out.get("ok") is True):
        return out  # the soft error is this op's result
    now = time.time()
    results = [
        {
            "req_id": r["req_id"],
            "indices": out["indices"][i],
            "scores": out["scores"][i],
            # One forward: the first answer byte is the whole answer.
            "ttft_ms": _clamp_ttft(now, r.get("arrived_wall")),
            "tokens": 0,
            "telemetry": {
                "path": "colocated",
                "prefill_t0_wall": t0_wall,
                "prefill_t1_wall": now,
                "admitted_wall": now,
                "joined_wall": now,
                "first_token_wall": now,
                "done_wall": now,
                "kv_wait_ms": 0.0,
                "occupancy_at_join": len(reqs),
                "cache_hit": False,
                "steps": 0,
            },
        }
        for i, r in enumerate(reqs)
    ]
    return {
        "ok": True,
        "op": "serve_classify",
        "device": out.get("device"),
        "model": out.get("model"),
        "n_requests": len(reqs),
        "results": results,
        "occupancy": float(len(reqs)),
        "max_occupancy": len(reqs),
        "elapsed_ms": (time.perf_counter() - t0) * 1000.0,
    }


# ---------------------------------------------------------------------------
# serve_summarize
# ---------------------------------------------------------------------------

def _resolve(payload: Dict[str, Any]):
    from agent_tpu_torch.models import bert
    from agent_tpu_torch.models.seq2seq import Seq2SeqConfig
    from agent_tpu_torch.ops._model_common import config_from_payload, resolve_model_id

    model_id = resolve_model_id(payload, "BART_MODEL", "summarize-default")
    if bert.is_hf_dir(model_id):
        raise ValueError("serve_summarize serves the in-house seq2seq family; checkpoint "
                         "directories stay on the batch map_summarize path")
    # The quant mode is the payload's model_config alone (no TPU_QUANT), as
    # the reference's serving ops resolve it; a mode other than int8/w8a16
    # serves float weights.
    return model_id, config_from_payload(payload, Seq2SeqConfig)


def _serve_knobs(ctx):
    """The agent's :class:`~agent_tpu_torch.config.ServeConfig`, else the
    ``SERVE_*`` environment."""
    cfg = getattr(ctx, "config", None) if ctx is not None else None
    serve = getattr(cfg, "serve", None) if cfg is not None else None
    if serve is None:
        from agent_tpu_torch.config import ServeConfig

        serve = ServeConfig.from_env()
    return serve


def stage(payload: Any, ctx: Optional[object] = None):
    """Host phase: validate the batch, byte-tokenize and pad every request
    to the bucket length the controller coalesced on."""
    t0 = time.perf_counter()
    if not isinstance(payload, dict):
        return "done", bad_input("payload must be a dict")
    try:
        reqs = _validate_requests(payload)
        model_id, cfg = _resolve(payload)
        stage_divisor(resolve_runtime(ctx), cfg, "seq2seq")  # pp or ep: bad_input
    except ValueError as exc:
        return "done", bad_input(str(exc))

    num_beams = payload.get("num_beams", 1)
    if isinstance(num_beams, bool) or not isinstance(num_beams, int) or \
            not 1 <= num_beams <= 16:
        return "done", bad_input("num_beams must be an int in [1, 16]")
    length_penalty = payload.get("length_penalty", 1.0)
    if isinstance(length_penalty, bool) or not isinstance(length_penalty, (int, float)) or \
            not -4.0 <= float(length_penalty) <= 4.0:
        return "done", bad_input("length_penalty must be a number in [-4, 4]")
    early_stopping = payload.get("early_stopping", False)
    if not isinstance(early_stopping, bool):
        return "done", bad_input("early_stopping must be a bool")
    min_length = payload.get("min_length", 0)
    if isinstance(min_length, bool) or not isinstance(min_length, int) or min_length < 0:
        return "done", bad_input("min_length must be a non-negative int")
    bucket = payload.get("bucket", cfg.max_src_len)
    if isinstance(bucket, bool) or not isinstance(bucket, int) or bucket < 1:
        return "done", bad_input("bucket must be a positive int")
    bucket = min(bucket, cfg.max_src_len)

    from agent_tpu_torch.models.tokenizer import byte_encode_pad

    # One padded length a batch (the controller's bucket): the prefill and
    # the engine's encoder state key on it.
    ids, lengths = byte_encode_pad([r["text"] for r in reqs], buckets=(bucket,),
                                   max_len_cap=bucket, add_bos=True, add_eos=True)
    limits = []
    for r in reqs:
        lim = r.get("max_length")
        if lim is None:
            lim = cfg.max_tgt_len
        if isinstance(lim, bool) or not isinstance(lim, int) or lim < 1:
            return "done", bad_input("max_length must be a positive int")
        limits.append(min(lim, cfg.max_tgt_len))
    state = {
        "t0": t0,
        "reqs": reqs,
        "ids": ids.astype(np.int32),
        "lengths": np.asarray(lengths, dtype=np.int32),
        "limits": limits,
        "bucket": int(ids.shape[1]),
        "model_id": model_id,
        "cfg": cfg,
        "num_beams": num_beams,
        "length_penalty": float(length_penalty),
        "early_stopping": early_stopping,
        "min_length": min_length,
        "t_staged": time.perf_counter(),
    }
    return "staged", state


def _params_key(model_id: str, cfg) -> str:
    """``map_summarize``'s weights key for the seq2seq family, so serving
    and the batch op share one copy on the card."""
    from agent_tpu_torch.ops.map_summarize import params_key

    return params_key(model_id, "seq2seq", cfg)


def _get_params(runtime, model_id: str, cfg):
    from agent_tpu_torch.ops.map_summarize import _get_model

    return _get_model(runtime, model_id, cfg, "seq2seq")


def _get_engine(runtime, model, state, serve):
    from agent_tpu_torch.models import seq2seq
    from agent_tpu_torch.models.decoding import ContinuousBatcher
    from agent_tpu_torch.models.tokenizer import BOS_ID, EOS_ID, PAD_ID
    from agent_tpu_torch.ops._model_common import cfg_key

    cfg = state["cfg"]
    slots = int(serve.decode_slots)
    micro_steps = int(serve.decode_micro_steps)
    key = (id(runtime), state["model_id"], cfg_key(cfg), state["bucket"], state["num_beams"],
           state["min_length"], state["length_penalty"], state["early_stopping"], slots,
           micro_steps, serve.kv_layout, serve.kv_block_size, serve.kv_pool_blocks)
    engine = _ENGINES.get(key)
    if engine is None:
        shards = model if isinstance(model, seq2seq.ShardedSeq2Seq) else None
        if serve.kv_layout == "paged":
            cache_factory = seq2seq.make_paged_cache_factory(
                cfg, block_size=serve.kv_block_size, pool_blocks=serve.kv_pool_blocks,
                device=runtime.device, shards=shards)
        else:
            cache_factory = seq2seq.make_cache_factory(cfg, device=runtime.device, shards=shards)
        engine = ContinuousBatcher(
            seq2seq.make_positional_step(model), cache_factory, slots=slots,
            vocab_size=cfg.vocab_size, max_tokens=cfg.max_tgt_len, enc_len=state["bucket"],
            d_model=cfg.d_model, start_id=BOS_ID, eos_id=EOS_ID, pad_id=PAD_ID,
            num_beams=state["num_beams"], min_length=state["min_length"],
            length_penalty=state["length_penalty"], early_stopping=state["early_stopping"],
            micro_steps=micro_steps)
        _ENGINES[key] = engine
    return engine


def _prefill_rows(runtime, model, state, serve):
    """Prefill this batch: prefix-cache hits come back from host memory,
    and only the rows that missed run the encoder, through the runtime's
    attention function. Returns ``(enc f32 [B, Ls, d_model], prefix
    delta)``; a hit row is the exact f32 array its cold prefill stored."""
    ids, lengths = state["ids"], state["lengths"]
    B, Ls = ids.shape
    cfg, model_id = state["cfg"], state["model_id"]
    cache = _get_prefix_cache(serve)
    enc = np.zeros((B, Ls, cfg.d_model), dtype=np.float32)
    hit = np.zeros((B,), dtype=bool)
    keys: List[Optional[str]] = [None] * B
    if cache is not None:
        from agent_tpu_torch.ops.prefix_cache import prefix_key

        version = _params_key(model_id, cfg)
        for i in range(B):
            keys[i] = prefix_key(version, ids[i])
            row = cache.get(keys[i])
            if row is not None:
                enc[i] = row
                hit[i] = True
    miss = np.nonzero(~hit)[0]
    ev0 = cache.evictions if cache is not None else 0
    t_pf0 = time.time()
    if miss.size:
        from agent_tpu_torch.kernels.flash_attention import keyless_rows
        from agent_tpu_torch.models import seq2seq

        with torch.inference_mode(), keyless_rows(lengths[miss]):
            ids_t = runtime.put_batch(ids[miss])
            n_t = runtime.put_batch(lengths[miss])
            mask = (torch.arange(Ls, device=n_t.device)[None, :] < n_t[:, None]).to(torch.int32)
            # f32 handoff: widening bf16 is exact, and the engine casts back.
            got = seq2seq.encode(model, ids_t, mask, runtime.attention_fn()).float()
        got = got.cpu().numpy()
        enc[miss] = got
        if cache is not None:
            for j, i in enumerate(miss):
                cache.put(keys[i], got[j])
    return enc, {
        "hits": int(hit.sum()),
        "misses": int(miss.size),
        "evictions": int((cache.evictions - ev0) if cache is not None else 0),
        # Telemetry side channel, popped by finalize: per-row hit flags and
        # the encoder's wall window.
        "row_hits": hit.tolist(),
        "prefill_t0_wall": t_pf0,
        "prefill_t1_wall": time.time(),
    }


def serve_admit(state: Dict[str, Any], ctx: Optional[object] = None) -> Dict[str, Any]:
    """Device phase, part 1: prefill as its own batched step (prefix hits
    skip it), then join the continuous engine between decode steps. Returns
    the handle the runner pumps. A disaggregated decode job's state already
    holds ``enc_rows`` (the prefill agent's handoff) and skips prefill."""
    runtime = device_runtime(ctx, "serve_summarize")
    cfg, model_id = state["cfg"], state["model_id"]
    model = _get_params(runtime, model_id, cfg)
    serve = _serve_knobs(ctx)
    engine = _get_engine(runtime, model, state, serve)
    if state.get("enc_rows") is not None:
        enc = np.asarray(state.pop("enc_rows"), dtype=np.float32)
        prefix = state.pop("prefix", None) or {"hits": 0, "misses": 0, "evictions": 0}
    else:
        enc, prefix = _prefill_rows(runtime, model, state, serve)
    Ls = state["ids"].shape[1]
    masks = (np.arange(Ls)[None, :] < state["lengths"][:, None]).astype(np.int32)
    t_admit = time.perf_counter()
    steps0, occ0 = engine.steps_run, engine.occupancy_sum
    tickets = [engine.admit(enc[i], masks[i], state["limits"][i],
                            data={"req_id": r["req_id"], "arrived_wall": r.get("arrived_wall")})
               for i, r in enumerate(state["reqs"][: len(state["limits"])])]
    return {
        "engine": engine,
        "tickets": tickets,
        "state": state,
        "prefix": prefix,
        "t_admit": t_admit,
        "steps0": steps0,
        "occ0": occ0,
        "device": runtime.platform,
    }


def serve_pump(handle: Dict[str, Any]) -> int:
    """One step of the handle's engine (finished sequences leave, the
    backlog joins). Returns the occupancy after the step."""
    engine = handle["engine"]
    engine.step()
    return engine.occupancy


def serve_done(handle: Dict[str, Any]) -> bool:
    return all(t.done_wall is not None for t in handle["tickets"])


def serve_collect(handle: Dict[str, Any]) -> Dict[str, Any]:
    """Handle -> executed state (finalize's input)."""
    engine, state = handle["engine"], handle["state"]
    d_steps = max(1, engine.steps_run - handle["steps0"])
    d_occ = engine.occupancy_sum - handle["occ0"]
    return {
        "state": state,
        "tickets": handle["tickets"],
        "device": handle["device"],
        "occupancy": round(d_occ / d_steps, 3),
        "max_occupancy": engine.max_occupancy,
        "prefix": handle.get("prefix"),
        "kv_blocks_total": engine.kv_blocks_total,
        "kv_blocks_free": engine.kv_blocks_free,
        "t_admit": handle["t_admit"],
        "t_device": time.perf_counter(),
    }


def execute(state: Dict[str, Any], ctx: Optional[object] = None) -> Dict[str, Any]:
    """Monolithic device phase: admit, then step until this job's tickets
    are done (the pipelined runner interleaves instead)."""
    handle = serve_admit(state, ctx)
    handle["engine"].run(handle["tickets"])
    return serve_collect(handle)


def finalize(executed: Dict[str, Any], ctx: Optional[object] = None) -> Dict[str, Any]:
    """Host phase: detokenize each ticket's tokens into the per-request
    entries the controller's front door fans out."""
    from agent_tpu_torch.models.tokenizer import ByteTokenizer
    from agent_tpu_torch.ops._model_common import stamp_rows

    state = executed["state"]
    tok = ByteTokenizer()
    prefix = dict(executed.get("prefix") or {"hits": 0, "misses": 0, "evictions": 0})
    # The telemetry side channel; the controller sees {hits, misses,
    # evictions}.
    row_hits = prefix.pop("row_hits", None)
    pf_t0 = prefix.pop("prefill_t0_wall", None)
    pf_t1 = prefix.pop("prefill_t1_wall", None)
    path = "disagg" if state.get("op_name") == "serve_decode" else "colocated"
    results: List[Dict[str, Any]] = []
    for i, ticket in enumerate(executed["tickets"]):
        row = ticket.tokens if ticket.tokens is not None else np.array([], int)
        results.append({
            "req_id": ticket.data["req_id"],
            "summary": tok.decode([t for t in row if t > 0]),
            "tokens": int(ticket.length),
            "steps": int(ticket.steps),
            "ttft_ms": _clamp_ttft(ticket.first_token_wall, ticket.data.get("arrived_wall")),
            # The engine's lifecycle walls and the prefill window: the
            # controller's TTFT decomposition and request-trace material.
            "telemetry": {
                "path": path,
                "prefill_t0_wall": pf_t0,
                "prefill_t1_wall": pf_t1,
                "admitted_wall": ticket.admitted_wall,
                "joined_wall": ticket.joined_wall,
                "first_token_wall": ticket.first_token_wall,
                "done_wall": ticket.done_wall,
                "kv_wait_ms": round(ticket.kv_wait_s * 1e3, 3),
                "join_step": int(ticket.join_step),
                "occupancy_at_join": int(ticket.occupancy_at_join),
                "cache_hit": bool(row_hits[i]) if (
                    isinstance(row_hits, list) and i < len(row_hits)) else False,
                "steps": int(ticket.steps),
                "events": [[name, wall] for name, wall in ticket.events],
            },
        })
    if ctx is not None and hasattr(ctx, "tags"):
        ctx.tags.setdefault("timings", {}).update(
            stage_ms=round((state["t_staged"] - state["t0"]) * 1e3, 3),
            device_ms=round((executed["t_device"] - executed["t_admit"]) * 1e3, 3),
        )
    stamp_rows(ctx, len(results))
    # A disaggregated decode job carries the prefill agent's counters
    # forward for metrics; that agent already billed the hits.
    forwarded = bool(prefix.pop("forwarded", False))
    if prefix.get("hits") and not forwarded and ctx is not None and hasattr(ctx, "tags"):
        from agent_tpu_torch.obs.usage import stamp_usage

        # Saved prefill bills as cache hits.
        stamp_usage(ctx.tags, cache_hit_rows=float(prefix["hits"]))
    return {
        "ok": True,
        "op": state.get("op_name", "serve_summarize"),
        "device": executed["device"],
        "model": state["model_id"],
        "num_beams": state["num_beams"],
        "n_requests": len(results),
        "results": results,
        "occupancy": executed["occupancy"],
        "max_occupancy": executed["max_occupancy"],
        "prefix_cache": prefix,
        "kv_blocks_total": executed.get("kv_blocks_total", 0),
        "kv_blocks_free": executed.get("kv_blocks_free", 0),
        "elapsed_ms": (time.perf_counter() - state["t0"]) * 1000.0,
    }


@register_op("serve_summarize")
def run_summarize(payload: Any, ctx: Optional[object] = None) -> Dict[str, Any]:
    """Monolithic entry: stage -> execute -> finalize inline."""
    phase, value = stage(payload, ctx)
    if phase == "done":
        return value
    return finalize(execute(value, ctx), ctx)


# Phase hooks for the pipelined drain, and the serving hooks its continuous
# loop drives (agent_tpu_torch.agent.pipeline).
run_summarize.stage = stage
run_summarize.execute = execute
run_summarize.finalize = finalize
run_summarize.serve_admit = serve_admit
run_summarize.serve_pump = serve_pump
run_summarize.serve_done = serve_done
run_summarize.serve_collect = serve_collect


# ---------------------------------------------------------------------------
# disaggregated prefill and decode
# ---------------------------------------------------------------------------

@register_op("serve_prefill")
def run_prefill(payload: Any, ctx: Optional[object] = None) -> Dict[str, Any]:
    """The prefill half of the split (``SERVE_DISAGG=1``): tokenize and run
    the prefix-cached encoder, posting the encoded rows as the result: b1
    columns to a controller that negotiated the binary wire, JSON floats
    otherwise (an f32 -> double -> f32 round trip is exact). The dep-gated
    ``serve_decode`` job receives this result as its ``partials``."""
    phase, state = stage(payload, ctx)
    if phase == "done":
        return state
    runtime = device_runtime(ctx, "serve_prefill")
    model = _get_params(runtime, state["model_id"], state["cfg"])
    enc, prefix = _prefill_rows(runtime, model, state, _serve_knobs(ctx))
    if ctx is not None and hasattr(ctx, "tags"):
        ctx.tags.setdefault("timings", {}).update(
            stage_ms=round((state["t_staged"] - state["t0"]) * 1e3, 3))
        if prefix.get("hits"):
            from agent_tpu_torch.obs.usage import stamp_usage

            # The saved prefill is this agent's, so its hits bill here.
            stamp_usage(ctx.tags, cache_hit_rows=float(prefix["hits"]))
    out: Dict[str, Any] = {
        "ok": True,
        "op": "serve_prefill",
        "device": runtime.platform,
        "model": state["model_id"],
        "n_requests": len(state["reqs"]),
        "bucket": state["bucket"],
        "prefix_cache": prefix,
        "elapsed_ms": (time.perf_counter() - state["t0"]) * 1000.0,
    }
    tags = getattr(ctx, "tags", None) if ctx is not None else None
    if isinstance(tags, dict) and tags.get("wire") == "b1":
        from agent_tpu_torch.data import wire

        return wire.attach_result_columns(out, {
            "enc_rows": np.ascontiguousarray(enc),
            "lengths": np.ascontiguousarray(state["lengths"]),
        })
    out["enc_rows"] = enc.tolist()
    out["lengths"] = state["lengths"].astype(int).tolist()
    return out


def _handoff_rows(payload: Dict[str, Any], state: Dict[str, Any]
                  ) -> Tuple[np.ndarray, Dict[str, Any]]:
    """The serve_prefill result this decode job resumes from: ``encoded``
    (one result) or dep-gated ``partials``. Returns its f32 encoded rows and
    the prefill agent's prefix counters, marked ``forwarded`` so the decode
    side reports them without billing them again."""
    if "encoded" in payload:
        sources: Any = [payload["encoded"]]
    elif "partials" in payload:
        sources = payload["partials"]
    else:
        raise ValueError("serve_decode requires 'encoded' (one serve_prefill result) or "
                         "dep-gated 'partials'")
    if not isinstance(sources, list) or len(sources) != 1:
        raise ValueError("serve_decode expects exactly one prefill result to resume from")
    src = sources[0]
    if not (isinstance(src, dict) and src.get("ok") is True
            and src.get("op") == "serve_prefill"):
        raise ValueError("handoff is not an ok serve_prefill result")
    enc = np.asarray(src.get("enc_rows"), dtype=np.float32)
    B, Ls = state["ids"].shape
    d_model = state["cfg"].d_model
    if enc.ndim != 3 or enc.shape != (B, Ls, d_model):
        raise ValueError(f"handoff enc_rows shape {enc.shape} does not match the batch "
                         f"({B}, {Ls}, {d_model}) — prefill and decode saw different "
                         f"payloads?")
    prefix = dict(src.get("prefix_cache") or {})
    prefix["forwarded"] = True
    return enc, prefix


def _decode_stage(payload: Any, ctx: Optional[object] = None):
    """serve_decode's stage: the serving stage plus the prefill handoff,
    whose rows land in the state so ``serve_admit`` skips the encoder. The
    byte tokenizer is deterministic, so the ids and lengths are the ones
    the prefill hashed and encoded."""
    phase, state = stage(payload, ctx)
    if phase == "done":
        return phase, state
    try:
        enc, prefix = _handoff_rows(payload, state)
    except ValueError as exc:
        return "done", bad_input(str(exc))
    state["enc_rows"] = enc
    state["prefix"] = prefix
    state["op_name"] = "serve_decode"
    return "staged", state


@register_op("serve_decode")
def run_decode(payload: Any, ctx: Optional[object] = None) -> Dict[str, Any]:
    """The decode half of the split: resume from the serve_prefill result's
    rows and run only the continuous engine; the engine gets the same f32
    rows as on the colocated path, so the tokens are the same."""
    phase, value = _decode_stage(payload, ctx)
    if phase == "done":
        return value
    return finalize(execute(value, ctx), ctx)


run_decode.stage = _decode_stage
run_decode.execute = execute
run_decode.finalize = finalize
run_decode.serve_admit = serve_admit
run_decode.serve_pump = serve_pump
run_decode.serve_done = serve_done
run_decode.serve_collect = serve_collect
