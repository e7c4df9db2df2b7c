"""Train a classifier on the card and write a servable artifact —
counterpart of ``agent_tpu.ops.train_classifier`` with the same op name,
payload, validation, soft errors and result keys.

- Payload: ``texts`` + ``labels`` lists, or CSV rows (``source_uri`` +
  optional ``start_row``/``shard_size``, whole file by default, and
  ``text_field``/``label_field``, read in one parse); ``output_path`` (required, ends
  in ``.npz``); ``model_config`` (EncoderConfig overrides; ``n_classes``
  defaults to the number of distinct labels); ``epochs`` (3),
  ``batch_size`` (64), ``learning_rate`` (1e-3), ``eval_fraction`` (0.2),
  ``seed`` (0), ``init_from`` (model id or ``.npz`` to warm-start).
- Result: ``{ok, op, output_path, n_train, n_eval, n_steps,
  first_epoch_loss, last_epoch_loss, eval_accuracy, label_names?,
  model_config, device, elapsed_ms}``. String labels map to ids by sorted
  order; the mapping ships in the result and in a
  ``<output_path>.labels.json`` sidecar. The artifact is the reference's
  flat ``.npz``, which ``map_classify_tpu`` of either package serves with
  ``{"model_path": output_path, "model_config": result["model_config"]}``.

Batches are the reference's: every ``round(1/eval_fraction)``-th row held
out, the rest permuted per epoch by ``np.random.default_rng(seed)`` and
tiled with ``np.resize`` to whole batches, so both packages see the same
batches. Each step is :func:`agent_tpu_torch.models.train.make_train_step`
with AdamW at optax's defaults and the runtime's differentiable attention
(the flash kernels in both directions on the card). The holdout accuracy
uses dense attention, as the reference's eval pass does. The op records
every epoch's loss in ``ctx.tags["train"]``.

A ``quant`` mode in ``model_config`` trains float weights, as the
reference's does (``TPU_QUANT`` is not read), and rides in the result's
``model_config`` for serving. ``moe_experts`` > 0 trains the Switch MoE
encoder with the aux loss (``models.train.MOE_AUX_WEIGHT``), and its
artifact holds the experts and routers; MoE with a quant mode is rejected,
as the reference rejects it, and so is ``pp`` > 1.

On a mesh with dp, tp or ep above 1 the model is a ``ShardedEncoder``
placed by the encoder's specs (sanitized, as the reference places its
training weights): batches round up to a dp multiple, each shard launches
the flash training kernels with its rows and heads, and the ``.npz`` is the
gathered flat layout, which a one-device runtime serves.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from agent_tpu_torch.ops import register_op
from agent_tpu_torch.utils.errors import bad_input

DEFAULT_EPOCHS = 3
DEFAULT_BATCH = 64
DEFAULT_LR = 1e-3
DEFAULT_EVAL_FRACTION = 0.2


def _collect_rows(payload: Dict[str, Any]) -> Tuple[List[str], List[Any]]:
    """Payload -> (texts, raw_labels); ValueError on a malformed payload."""
    texts = payload.get("texts")
    labels = payload.get("labels")
    if texts is not None or labels is not None:
        if (
            not isinstance(texts, list)
            or not isinstance(labels, list)
            or not texts
            or len(texts) != len(labels)
            or not all(isinstance(t, str) and t for t in texts)
        ):
            raise ValueError("texts and labels must be equal-length non-empty lists")
        return texts, labels
    if "source_uri" not in payload:
        raise ValueError("payload requires 'texts'+'labels' or 'source_uri' CSV addressing")
    from agent_tpu_torch.data.csv_index import count_rows, read_shard, resolve_shard_payload

    text_field = payload.get("text_field", "text")
    label_field = payload.get("label_field", "label")
    for key, val in (("text_field", text_field), ("label_field", label_field)):
        if not isinstance(val, str) or not val:
            raise ValueError(f"{key} must be a non-empty string")
    p = dict(payload)
    if "shard_size" not in p:
        # Training defaults to the whole file, not the 100-row shard default.
        path, start, _ = resolve_shard_payload({**p, "shard_size": 1})
        p["shard_size"] = max(1, count_rows(path) - start)
    path, start, size = resolve_shard_payload(p)
    # One parse serves both columns. Integrity problems raise RuntimeError,
    # so the task fails and retries, never a soft result that trains on
    # nothing.
    rows = read_shard(path, start, size)
    if not rows:
        raise RuntimeError(f"shard [{start}, {start + size}) of {path!r} is empty")
    for field in (text_field, label_field):
        missing = sum(1 for r in rows if field not in r)
        if missing:
            raise RuntimeError(f"column {field!r} missing from {missing} rows of {path!r}")
    return [r[text_field] for r in rows], [r[label_field] for r in rows]


def _map_labels(raw: List[Any]) -> Tuple[np.ndarray, Optional[List[str]]]:
    """Labels -> int ids. All-int labels pass through; strings map by sorted
    order (returned as label_names, index = class id)."""
    try:
        ids = [int(v) for v in raw]
        if ids and min(ids) >= 0 and all(str(v).strip().lstrip("+").isdigit() for v in raw):
            return np.asarray(ids, dtype=np.int32), None
    except (TypeError, ValueError):
        pass
    names = sorted({str(v) for v in raw})
    index = {n: i for i, n in enumerate(names)}
    return np.asarray([index[str(v)] for v in raw], dtype=np.int32), names


def _get_cfg(payload: Dict[str, Any], n_labels: int):
    """The model config; ValueError for what the port does not train yet."""
    from agent_tpu_torch.models.encoder import EncoderConfig
    from agent_tpu_torch.models.layers import config_dtype
    from agent_tpu_torch.ops._model_common import config_from_payload

    cfg = config_from_payload(payload, EncoderConfig)
    if "n_classes" not in (payload.get("model_config") or {}):
        cfg = dataclasses.replace(cfg, n_classes=max(2, n_labels))
    if cfg.pp > 1:
        raise ValueError("train_classifier does not support pp configs")
    if cfg.moe_experts > 0 and cfg.quant != "none":
        raise ValueError(f"MoE training does not support quant={cfg.quant}")
    config_dtype(cfg.dtype)  # the reference's error on a dtype it cannot serve
    return cfg


def stage(payload: Any) -> Tuple[str, Dict[str, Any]]:
    """Host-only phase: ``("done", soft_error)``, or ``("staged", state)``
    with the config, the tokenized rows and the holdout split. Touches no
    device."""
    t0 = time.perf_counter()
    if not isinstance(payload, dict):
        return "done", bad_input("payload must be a dict")
    output_path = payload.get("output_path")
    if not isinstance(output_path, str) or not output_path.endswith(".npz"):
        return "done", bad_input("output_path is required and must end in .npz")

    epochs = payload.get("epochs", DEFAULT_EPOCHS)
    batch_size = payload.get("batch_size", DEFAULT_BATCH)
    lr = payload.get("learning_rate", DEFAULT_LR)
    eval_fraction = payload.get("eval_fraction", DEFAULT_EVAL_FRACTION)
    for name, v, lo in (("epochs", epochs, 1), ("batch_size", batch_size, 1)):
        if isinstance(v, bool) or not isinstance(v, int) or v < lo:
            return "done", bad_input(f"{name} must be an int >= {lo}")
    if not isinstance(lr, (int, float)) or isinstance(lr, bool) or lr <= 0:
        return "done", bad_input("learning_rate must be a positive number")
    if not isinstance(eval_fraction, (int, float)) or isinstance(eval_fraction, bool) \
            or not 0 <= eval_fraction < 1:
        return "done", bad_input("eval_fraction must be in [0, 1)")

    init_from = payload.get("init_from")
    if init_from is not None and (not isinstance(init_from, str) or not init_from):
        return "done", bad_input("init_from must be a non-empty string")
    if isinstance(init_from, str) and init_from.endswith(".npz") \
            and not os.path.exists(init_from):
        # Training from scratch on a typo'd warm-start path would ship a
        # model that never saw the intended weights.
        return "done", bad_input(f"init_from checkpoint not found: {init_from!r}")

    try:
        texts, raw_labels = _collect_rows(payload)
        labels, label_names = _map_labels(raw_labels)
        n_labels = int(labels.max()) + 1 if labels.size else 2
        cfg = _get_cfg(payload, n_labels)
    except ValueError as exc:
        return "done", bad_input(str(exc))
    if labels.size and int(labels.max()) >= cfg.n_classes:
        return "done", bad_input(f"label id {int(labels.max())} >= n_classes {cfg.n_classes}")

    from agent_tpu_torch.models.tokenizer import DEFAULT_BUCKETS, byte_encode_pad

    # One static shape for the whole run: the smallest bucket covering the
    # longest row (capped by the model), every batch padded to it.
    buckets = [b for b in DEFAULT_BUCKETS if b <= cfg.max_len] or [cfg.max_len]
    ids_all, len_all = byte_encode_pad(texts, buckets=buckets, max_len_cap=cfg.max_len)
    L = ids_all.shape[1]
    mask_all = (np.arange(L)[None, :] < len_all[:, None]).astype(np.int32)

    # Deterministic holdout: every round(1/f)-th row evaluates, the rest train.
    n = len(texts)
    idx = np.arange(n)
    if eval_fraction > 0 and n >= 5:
        stride = max(2, int(round(1.0 / eval_fraction)))
        eval_idx = idx[::stride]
        train_idx = np.setdiff1d(idx, eval_idx)
    else:
        eval_idx = np.empty(0, dtype=np.int64)
        train_idx = idx
    if train_idx.size == 0:
        return "done", bad_input("no training rows after eval split")
    return "staged", {
        "t0": t0, "cfg": cfg, "output_path": output_path, "epochs": epochs,
        "batch_size": batch_size, "lr": float(lr), "seed": payload.get("seed", 0),
        "init_from": init_from, "ids": ids_all, "mask": mask_all, "labels": labels,
        "label_names": label_names, "train_idx": train_idx, "eval_idx": eval_idx,
    }


def _init_params(state: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Fresh or warm-started initial weights (the ``init_from`` path was
    checked in :func:`stage`)."""
    from agent_tpu_torch.models import encoder

    init_from, cfg = state["init_from"], state["cfg"]
    if init_from:
        if init_from.endswith(".npz"):
            return encoder.load_npz(init_from, cfg)
        return encoder.init_params(cfg, model_id=init_from)
    return encoder.init_params(cfg, model_id=f"train-seed:{state['seed']}")


@register_op("train_classifier")
def run(payload: Any, ctx: Optional[object] = None) -> Dict[str, Any]:
    phase, state = stage(payload)
    if phase == "done":
        return state
    from agent_tpu_torch.ops._model_common import device_runtime

    runtime = device_runtime(ctx, "train_classifier")

    from agent_tpu_torch.kernels.flash_attention import keyless_rows
    from agent_tpu_torch.models import checkpoint, encoder, train
    from agent_tpu_torch.ops._model_common import cfg_key

    cfg = state["cfg"]
    ids_all, mask_all, labels = state["ids"], state["mask"], state["labels"]
    train_idx, eval_idx = state["train_idx"], state["eval_idx"]
    dp = runtime.axis_size("dp")
    B = -(-state["batch_size"] // dp) * dp  # round up to a dp multiple
    rng = np.random.default_rng(state["seed"])

    if runtime.sharded:
        from agent_tpu_torch.parallel import shardings

        flat = _init_params(state)
        specs = shardings.placement_specs(runtime.mesh.shape, flat,
                                          shardings.encoder_specs(cfg))
        model = encoder.ShardedEncoder(flat, cfg, specs, runtime.mesh, trainable=True)
    else:
        model = encoder.from_jax_params(_init_params(state), cfg, device=runtime.device,
                                        trainable=True)
    init_state, step = train.make_train_step(
        cfg, train.adamw(state["lr"]), attn_fn=runtime.train_attention_fn())
    opt = init_state(model)

    epoch_losses: List[float] = []
    n_steps = 0
    t_train = time.perf_counter()
    for _ in range(state["epochs"]):
        order = rng.permutation(train_idx)
        # Tile the tail so every step sees a full [B, L] batch (static shape);
        # np.resize cycles the array, so n_train < B still fills a batch.
        order = np.resize(order, -(-order.size // B) * B)
        losses = []
        for s in range(0, order.size, B):
            take = order[s: s + B]
            with keyless_rows(mask_all[take].sum(axis=1)):
                model, opt, loss = step(model, opt, runtime.put_batch(ids_all[take]),
                                        runtime.put_batch(mask_all[take]),
                                        runtime.put_batch(labels[take]))
            losses.append(loss)
            n_steps += 1
        epoch_losses.append(float(np.mean(torch.stack(losses).cpu().numpy(),
                                          dtype=np.float64)))
    train_ms = (time.perf_counter() - t_train) * 1000.0

    # Holdout accuracy through the serving forward's dense attention.
    eval_accuracy = None
    if eval_idx.size:
        take = np.resize(eval_idx, -(-eval_idx.size // dp) * dp)
        with torch.inference_mode():
            logits = model(runtime.put_batch(ids_all[take]), runtime.put_batch(mask_all[take]))
        pred = logits.argmax(dim=-1).cpu().numpy()[: eval_idx.size]
        eval_accuracy = float(np.mean(pred == labels[eval_idx]))

    output_path = state["output_path"]
    checkpoint.save_npz(model, output_path)
    label_names = state["label_names"]
    if label_names is not None:
        with open(output_path + ".labels.json", "w", encoding="utf-8") as f:
            json.dump(label_names, f)

    if ctx is not None and hasattr(ctx, "tags"):
        ctx.tags["train"] = {"epoch_losses": epoch_losses, "train_ms": train_ms}
    out: Dict[str, Any] = {
        "ok": True,
        "op": "train_classifier",
        "output_path": output_path,
        "n_train": int(train_idx.size),
        "n_eval": int(eval_idx.size),
        "n_steps": n_steps,
        "first_epoch_loss": epoch_losses[0],
        "last_epoch_loss": epoch_losses[-1],
        "eval_accuracy": eval_accuracy,
        # Serve with: {"model_path": output_path, "model_config": this}.
        "model_config": dict(cfg_key(cfg)),
        "device": runtime.platform,
        "elapsed_ms": (time.perf_counter() - state["t0"]) * 1000.0,
    }
    if label_names is not None:
        out["label_names"] = label_names
    return out
