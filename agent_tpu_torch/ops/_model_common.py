"""Shared plumbing of the model-backed ops — the part of
``agent_tpu.ops._model_common`` that ``map_classify_tpu`` and
``map_summarize`` use: model-id and config resolution (the quant mode
included: :func:`apply_quant_env`), config-aware cache keys, batch and
length buckets, host staging of texts into padded chunks, the result sink,
and the analytic-FLOPs and rows stamps.

The reference's ``maybe_quantize_params`` has no twin here: each family's
loader quantizes its f32 tree on the host when ``cfg.quant`` asks for it
(``models.quant.quantize_tree``), before the weights reach the card.
"""

from __future__ import annotations

import json
import os
from dataclasses import fields, replace
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch


def encoder_fwd_flops(batch: int, seq_len: int, d_model: int, d_ff: int,
                      n_layers: int, n_classes: int = 0) -> float:
    """Forward matmul FLOPs of ``batch`` rows through an encoder stack at
    padded length ``seq_len``: QKVO projections + score/value products +
    FFN per layer, plus the classifier head (2·M·N·K per matmul)."""
    d, f, L = float(d_model), float(d_ff), float(seq_len)
    attn_proj = 8.0 * L * d * d
    attn_sdpa = 4.0 * L * L * d
    ffn = 4.0 * L * d * f
    return batch * (n_layers * (attn_proj + attn_sdpa + ffn) + 2.0 * d * n_classes)


def seq2seq_fwd_flops(batch: int, src_len: int, new_tokens: int, d_model: int,
                      d_ff: int, n_enc_layers: int, n_dec_layers: int,
                      vocab_size: int = 0, num_beams: int = 1) -> float:
    """Forward matmul FLOPs of an encode + incremental greedy/beam decode:
    the encoder stack over ``src_len``, then per generated token and row in
    flight (beams multiply the rows) a one-position decoder step (self- and
    cross-attention projections, FFN, cross-attention over the ``src_len``
    cached keys, vocab projection)."""
    d, f = float(d_model), float(d_ff)
    enc = encoder_fwd_flops(batch, src_len, d_model, d_ff, n_enc_layers)
    rows = float(batch * max(1, num_beams))
    per_tok_layer = 8.0 * d * d + 8.0 * d * d + 4.0 * src_len * d + 4.0 * d * f
    return enc + rows * new_tokens * (n_dec_layers * per_tok_layer + 2.0 * d * vocab_size)


def stamp_device_flops(ctx, flops: float, shape: str) -> None:
    """Accumulate an analytic-FLOPs estimate and its dominant shape bucket
    into ``ctx.tags["device_attr"]``; no-op without a ctx."""
    if ctx is None or not hasattr(ctx, "tags") or flops <= 0:
        return
    attr = ctx.tags.setdefault("device_attr", {})
    attr["flops"] = attr.get("flops", 0.0) + float(flops)
    attr["shape"] = str(shape)


def stamp_rows(ctx, rows: Any) -> None:
    """Accumulate the rows this task processed into ``ctx.tags["usage"]``;
    no-op without a ctx or a positive int count."""
    if ctx is None or not hasattr(ctx, "tags"):
        return
    if isinstance(rows, bool) or not isinstance(rows, int) or rows <= 0:
        return
    usage = ctx.tags.setdefault("usage", {})
    usage["rows"] = usage.get("rows", 0.0) + float(rows)


def device_runtime(ctx, op: str):
    """The runtime ``op`` executes on: the context's (built if it has
    none), else the process singleton. On a mesh over several processes it
    raises ``RuntimeError`` naming the op (``TorchRuntime.require_local``):
    the reference cannot fetch such a result either."""
    if ctx is not None and getattr(ctx, "require_runtime", None):
        runtime = ctx.require_runtime()
    else:
        from agent_tpu_torch.runtime.runtime import get_runtime

        runtime = get_runtime()
    runtime.require_local(op)
    return runtime


def resolve_runtime(ctx):
    """The runtime the op will execute on (the context's, built if it has
    none, else the process singleton), or None when no device is there: a
    host-side read of its mesh for the guards and the staging divisor."""
    try:
        if ctx is not None and getattr(ctx, "require_runtime", None):
            return ctx.require_runtime()
        from agent_tpu_torch.runtime.runtime import get_runtime

        return get_runtime()
    except Exception:  # noqa: BLE001 — no device: one-device staging
        return None


# The families map_summarize, serve_infer and summarize_mpmd serve.
DECODER_FAMILIES = ("seq2seq", "t5", "bart")


def stage_divisor(rt, cfg, family: str) -> int:
    """What every staged batch must divide by (the reference's staging
    divisor): dp; on a pp mesh pp · dp (the pipeline's microbatches of each
    replica); for a pp taken from ``model_config`` every device (the dp ×
    pp mesh derived from them). 1 without a runtime. A decoder family runs
    on dp and tp alone: a mesh with pp or ep above 1 raises ValueError (a
    soft ``bad_input``), since the reference runs no decoder over either."""
    if rt is None:
        return 1
    if family in DECODER_FAMILIES:
        other = {a: rt.axis_size(a) for a in ("pp", "ep") if rt.axis_size(a) > 1}
        if other:
            raise ValueError(f"the {family} family serves on dp and tp meshes; this mesh has "
                             f"{other}, over which no decoder runs")
        return rt.axis_size("dp")
    if family == "encoder" and rt.axis_size("pp") > 1:
        return rt.axis_size("pp") * rt.axis_size("dp")
    if family == "encoder" and cfg.pp > 1:
        return rt.n_devices
    return rt.axis_size("dp")


def resolve_model_id(payload: Dict[str, Any], env_var: str, default: str) -> str:
    """payload ``model_path`` -> env var -> default."""
    mp = payload.get("model_path")
    if isinstance(mp, str) and mp:
        return mp
    return os.environ.get(env_var) or default


def config_from_payload(payload: Dict[str, Any], config_cls):
    """``config_cls`` with any recognised ``model_config`` overrides."""
    overrides = payload.get("model_config")
    if isinstance(overrides, dict):
        return config_cls(**{k: v for k, v in overrides.items()
                             if k in config_cls.__dataclass_fields__})
    return config_cls()


def resolve_quant(payload: Dict[str, Any], cfg) -> str:
    """The serving ops' quant mode, as the reference's ``apply_quant_env``
    resolves it: a ``quant`` key in the payload's ``model_config`` wins
    (validated: ValueError, a caller error); else ``TPU_QUANT`` (validated:
    RuntimeError, a worker's misconfiguration that fails the shard for a
    retry); else the config's."""
    from agent_tpu_torch.models.quant import validate_quant

    overrides = payload.get("model_config")
    if isinstance(overrides, dict) and "quant" in overrides:
        return validate_quant(overrides["quant"])
    env = os.environ.get("TPU_QUANT", "").strip().lower()
    if env:
        try:
            return validate_quant(env)
        except ValueError as exc:
            raise RuntimeError(f"bad TPU_QUANT env: {exc}") from exc
    return cfg.quant


def apply_quant_env(payload: Dict[str, Any], cfg):
    """``cfg`` with the quant mode :func:`resolve_quant` gives (the
    reference's ``apply_quant_env``)."""
    return replace(cfg, quant=resolve_quant(payload, cfg))


def cfg_key(cfg) -> Tuple:
    """Hashable fingerprint of a frozen config dataclass, so distinct
    configs never share weights or forward functions."""
    return tuple((f.name, getattr(cfg, f.name)) for f in fields(cfg))


def batch_buckets(dp: int, cap: int) -> List[int]:
    """Batch-size buckets dp, 2·dp, … <= cap."""
    out, b = [], max(1, dp)
    while b <= cap:
        out.append(b)
        b *= 2
    return out or [max(1, dp)]


def length_buckets_for(max_len: int) -> List[int]:
    """Length buckets capped at ``max_len``, with ``max_len`` itself as the
    top bucket, so a full-length row is always representable."""
    from agent_tpu_torch.models.tokenizer import DEFAULT_BUCKETS

    return [b for b in DEFAULT_BUCKETS if b < max_len] + [max_len]


def iter_chunks(seqs: Sequence, max_chunk: int) -> Iterator[Sequence]:
    """Slice an oversize batch into <= max_chunk pieces."""
    for i in range(0, len(seqs), max_chunk):
        yield seqs[i: i + max_chunk]


# Dispatch budget (rows × padded length) for chunks whose attention takes
# the dense path, which holds [B, H, L, L] score temporaries. The value is
# the reference's and has not been measured on an H100; on this port only
# shapes the flash kernel does not take (another d_head or dtype) use it.
DENSE_CHUNK_TOKENS = 131_072


def chunk_token_budget() -> int:
    """The dense-path dispatch budget: ``TPU_CHUNK_TOKENS`` when set, else
    ``DENSE_CHUNK_TOKENS`` (reference ``chunk_token_budget``)."""
    env = os.environ.get("TPU_CHUNK_TOKENS", "").strip()
    return int(env) if env else DENSE_CHUNK_TOKENS


def split_padded_chunk(ids: np.ndarray, lengths: np.ndarray, n: int, dp: int,
                       d_head: int, dtype: torch.dtype) -> List[Tuple]:
    """Split one padded ``(ids [B, L], lengths [B], n_real)`` chunk into
    dispatch slices of at most :func:`chunk_token_budget` tokens when its
    attention takes the dense path; kernel-path chunks stay whole. Slices
    are the largest batch bucket within budget (so they divide B); slices
    holding only padding rows are dropped."""
    from agent_tpu_torch.kernels.flash_attention import selects_flash

    B, L = ids.shape
    budget = chunk_token_budget()
    if selects_flash(L, d_head, dtype) or B * L <= budget:
        return [(ids, lengths, n)]
    rows = max(1, budget // L)
    cap = max(1, dp)
    while cap * 2 <= rows:
        cap *= 2
    if cap >= B:
        return [(ids, lengths, n)]
    out: List[Tuple] = []
    for s in range(0, B, cap):
        n_i = min(n - s, cap)
        if n_i <= 0:
            break
        out.append((ids[s:s + cap], lengths[s:s + cap], n_i))
    return out


def stage_text_chunks(dp: int, texts: Sequence[str], *, max_len: int,
                      vocab_size: int, max_batch: int, d_head: int = 0,
                      dtype: Optional[torch.dtype] = None, add_bos: bool = False,
                      add_eos: bool = False, encode_pad=None) -> List[Tuple]:
    """Pure host: tokenize and pad ``texts`` into dispatch chunks
    ``[(ids[B, L], lengths[B] int32, n_real_rows), ...]``.

    ``encode_pad(chunk, length_buckets, batch_buckets) -> (ids, lengths)``
    supplies another tokenizer (a checkpoint's); the default is the fused
    byte path, with BOS/EOS when asked. The wire is the narrowest exact
    encoding: uint8 unshifted bytes when the byte vocabulary holds all 256
    byte ids and no BOS/EOS is added (the device rebuilds ``(raw +
    N_SPECIAL) * mask``), else uint16 ids for vocabularies < 2^16, else
    int32. uint8 on this wire always means shifted-raw bytes, so a custom
    tokenizer may not return it. With ``dtype`` given, chunks whose
    attention takes the dense path are split to the dense budget
    (:func:`split_padded_chunk`); without, chunks stay whole, as the
    reference stages summarize.
    """
    from agent_tpu_torch.models.tokenizer import N_SPECIAL, byte_encode_pad

    buckets = length_buckets_for(max_len)
    bbuckets = batch_buckets(dp, max_batch)
    wire_dtype = np.uint16 if vocab_size <= (1 << 16) else np.int32
    custom = encode_pad is not None
    raw_u8 = not custom and not add_bos and not add_eos and vocab_size >= N_SPECIAL + 256
    if not custom:
        def encode_pad(chunk, lb, bb):
            return byte_encode_pad(chunk, buckets=lb, batch_buckets=bb, max_len_cap=max_len,
                                   add_bos=add_bos, add_eos=add_eos, raw_uint8=raw_u8)
    chunks: List[Tuple] = []
    for chunk in iter_chunks(texts, bbuckets[-1]):
        ids, lengths = encode_pad(chunk, buckets, bbuckets)
        if ids.dtype == np.uint8 and custom:
            raise TypeError("encode_pad returned uint8 ids: the uint8 wire is reserved "
                            "for the internal raw-byte path; return int32/uint16 ids "
                            "from custom tokenizers")
        if not raw_u8:
            ids = ids.astype(wire_dtype)
        if dtype is None:
            chunks.append((ids, lengths, len(chunk)))
        else:
            chunks.extend(split_padded_chunk(ids, lengths, len(chunk), dp, d_head, dtype))
    return chunks


def validate_start_row(payload: Dict[str, Any]) -> int:
    """``start_row`` as a non-negative int (0 when absent); ValueError on
    anything else — sink files are named by it."""
    raw = payload.get("start_row", 0)
    if raw is None:
        return 0
    if isinstance(raw, bool) or not isinstance(raw, int) or raw < 0:
        raise ValueError("start_row must be a non-negative int")
    return raw


def validate_output_uri(payload: Dict[str, Any]):
    """Optional result sink: ``output_uri`` names a local directory the op
    writes full per-row results to, returning only a receipt. Returns the
    directory (created if missing) or None; ValueError when unusable."""
    uri = payload.get("output_uri")
    if uri is None:
        return None
    if not isinstance(uri, str) or not uri:
        raise ValueError("output_uri must be a non-empty directory path")
    try:
        os.makedirs(uri, exist_ok=True)
    except OSError as exc:
        raise ValueError(f"output_uri not creatable: {exc}") from exc
    if not os.path.isdir(uri) or not os.access(uri, os.W_OK):
        raise ValueError(f"output_uri not a writable directory: {uri}")
    return uri


def write_output_shard(output_dir: str, op: str, start_row: int,
                       rows: Iterator[Dict[str, Any]]) -> Tuple[str, int]:
    """Write one shard's rows as JSONL -> (path, n_rows); line k holds
    dataset row ``start_row + k``. Atomic (tmp + ``os.replace``), so a
    retried shard rewrites identical content and never leaves a torn file."""
    path = os.path.join(output_dir, f"{op}_rows_{start_row:012d}.jsonl")
    tmp = f"{path}.tmp.{os.getpid()}"
    n = 0
    with open(tmp, "w") as f:
        for row in rows:
            f.write(json.dumps(row, separators=(",", ":")))
            f.write("\n")
            n += 1
    os.replace(tmp, path)
    return path, n
