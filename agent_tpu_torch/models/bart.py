"""HF-BART-compatible seq2seq in PyTorch — counterpart of
``agent_tpu.models.bart``: ``map_summarize`` serves a local Hugging Face BART
checkpoint directory (``config.json`` + ``model.safetensors`` or
``pytorch_model.bin`` + ``vocab.json``/``merges.txt``), the reference's own
summarize model family (bart-large-cnn).

Faithful to ``transformers``' BART as the reference is: post-LN encoder and
decoder (LayerNorm eps 1e-5), learned positions at offset 2 plus the
embedding LayerNorm, erf-exact GELU, the lm head tied to the shared
embedding plus ``final_logits_bias``. Generation runs on the port's decode
loops (:mod:`agent_tpu_torch.models.decoding`), greedy or beam, with the
checkpoint's ``decoder_start_token_id`` and the forced first and last ids
(``forced_bos_token_id``, ``forced_eos_token_id``).

``attn_fn`` serves the encoder pass (``runtime.attention_fn()``: the flash
kernel in every encoder layer, or ring attention over ``sp``); the cached
decoder's self- and cross-attention are dense, as in the reference's
``generate``. Weights are a nested dict named as the reference's tree,
dense weights ``[in, out]``, on one device: matmul weights, biases and the
embeddings in the compute dtype, layer norms and ``final_logits_bias`` in
f32. No network access: checkpoints load from local disk.

Over a mesh the weights are a :class:`ShardedBart` (``models.sharded_decoder``,
placed by ``shardings.bart_specs``): rows over dp, heads, ``fc1``'s columns
and the vocabulary over tp; the learned positions, every LayerNorm and
``final_logits_bias`` replicate, the bias added after the logits' gather.
One device's tree runs the same group code as the one shard.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from agent_tpu_torch.models import layers, quant
from agent_tpu_torch.models.layers import AttnFn, Params
from agent_tpu_torch.models.sharded_decoder import ShardedDecoder, as_mesh, row_out

_LN_EPS = 1e-5  # BART's LayerNorm eps


@dataclass(frozen=True)
class BartConfig:
    """Mirror of the HF BART ``config.json`` fields the forward needs (the
    reference's fields and defaults)."""

    vocab_size: int = 50265
    d_model: int = 768
    n_heads: int = 12
    n_enc_layers: int = 6
    n_dec_layers: int = 6
    d_ff: int = 3072
    max_position: int = 1024
    pad_id: int = 1
    bos_id: int = 0
    eos_id: int = 2
    decoder_start_id: int = 2
    forced_bos_id: Optional[int] = None
    forced_eos_id: Optional[int] = 2  # HF BART forces EOS at max length
    scale_embedding: bool = False
    dtype: str = "bfloat16"
    # "int8" (W8A8) or "w8a16" (weight only): self and cross q/k/v/o, fc1
    # and fc2 (models.quant); the tied lm head stays float.
    quant: str = "none"

    # The uniform serving-config view map_summarize reads off any family.
    @property
    def max_src_len(self) -> int:
        return self.max_position

    @property
    def max_tgt_len(self) -> int:
        return self.max_position

    @property
    def compute_dtype(self) -> torch.dtype:
        return layers.compute_dtype(self.dtype)

    @classmethod
    def from_hf_json(cls, path: str, **overrides) -> "BartConfig":
        try:
            with open(path) as f:
                hf = json.load(f)
        except json.JSONDecodeError as exc:
            # Not a ValueError to callers: a corrupt checkpoint is a
            # retryable integrity failure, not bad input.
            raise RuntimeError(f"unreadable checkpoint config.json at {path}: {exc}") from exc
        if hf.get("model_type") not in (None, "bart"):
            raise RuntimeError(f"not a BART checkpoint (model_type={hf.get('model_type')!r})")
        # Newer transformers saves the generation controls to a sibling
        # generation_config.json; overlay the ones generation honours.
        gen_path = os.path.join(os.path.dirname(path), "generation_config.json")
        if os.path.exists(gen_path):
            try:
                with open(gen_path) as f:
                    gen = json.load(f)
                for key in ("decoder_start_token_id", "forced_bos_token_id",
                            "forced_eos_token_id"):
                    if gen.get(key) is not None:
                        hf[key] = gen[key]
            except json.JSONDecodeError:
                pass  # optional overlay; config.json stays authoritative
        # The FFN is exact GELU (bart-base/large); any other activation would
        # be served wrong, so it fails loudly.
        act = hf.get("activation_function", "gelu")
        if act != "gelu":
            raise RuntimeError(f"unsupported BART activation_function={act!r} "
                               "(supported: 'gelu')")
        fields = dict(
            vocab_size=hf["vocab_size"],
            d_model=hf["d_model"],
            n_heads=hf["encoder_attention_heads"],
            n_enc_layers=hf["encoder_layers"],
            n_dec_layers=hf["decoder_layers"],
            d_ff=hf["encoder_ffn_dim"],
            max_position=hf["max_position_embeddings"],
            pad_id=hf.get("pad_token_id", 1),
            bos_id=hf.get("bos_token_id", 0),
            eos_id=hf.get("eos_token_id", 2),
            decoder_start_id=hf.get("decoder_start_token_id", hf.get("eos_token_id", 2)),
            forced_bos_id=hf.get("forced_bos_token_id"),
            forced_eos_id=hf.get("forced_eos_token_id", 2),
            scale_embedding=hf.get("scale_embedding", False),
        )
        fields.update(overrides)
        return cls(**fields)


def _ln(p: Params, x: torch.Tensor) -> torch.Tensor:
    return layers.layer_norm(x, p["scale"], p["bias"], _LN_EPS)


_dense = layers.dense_leaf


def _embed(params: Params, branch: str, ids: torch.Tensor, pos0: int,
           cfg: BartConfig) -> torch.Tensor:
    """Token + learned position embeddings (HF's row = position + 2), then
    the embedding LayerNorm. ``pos0`` is the position of ``ids[:, 0]``."""
    return _embed_rest(params, branch, params["embed"][ids.long()], pos0, cfg)


def _embed_rest(params: Params, branch: str, x: torch.Tensor, pos0: int,
                cfg: BartConfig) -> torch.Tensor:
    """:func:`_embed` after the token lookup ``x`` [B, L, d]."""
    if cfg.scale_embedding:
        x = x * torch.tensor(float(np.sqrt(cfg.d_model)), dtype=x.dtype)
    L = x.shape[1]
    p = params[branch]
    return _ln(p["ln_emb"], x + p["pos"][pos0 + 2:pos0 + 2 + L][None])


def _heads(t: torch.Tensor, cfg: BartConfig) -> torch.Tensor:
    """[B, L, H·d_head] -> [B, H, L, d_head] (H: the heads a shard holds)."""
    B, L, _ = t.shape
    return t.view(B, L, -1, cfg.d_model // cfg.n_heads).transpose(1, 2)


def _merge(ctx: torch.Tensor, cfg: BartConfig) -> torch.Tensor:
    """[B, H, L, d_head] -> [B, L, H·d_head]."""
    B, _, L, _ = ctx.shape
    return ctx.transpose(1, 2).reshape(B, L, -1)


def _mha(blk: Params, q_in: torch.Tensor, kv_in: torch.Tensor, mask: torch.Tensor,
         cfg: BartConfig, attn_fn: AttnFn) -> torch.Tensor:
    """Multi-head attention through ``attn_fn``; blk = {q, k, v, o}."""
    dtype = cfg.compute_dtype
    ctx = attn_fn(_heads(_dense(blk["q"], q_in, dtype), cfg),
                  _heads(_dense(blk["k"], kv_in, dtype), cfg),
                  _heads(_dense(blk["v"], kv_in, dtype), cfg), mask)
    return _dense(blk["o"], _merge(ctx, cfg), dtype)


def _ffn_hidden(blk: Params, x: torch.Tensor, cfg: BartConfig) -> torch.Tensor:
    """``fc1`` and the GELU (a shard's columns of them)."""
    return F.gelu(_dense(blk["fc1"], x, cfg.compute_dtype).float(),
                  approximate="none").to(cfg.compute_dtype)


def _ffn(blk: Params, x: torch.Tensor, cfg: BartConfig) -> torch.Tensor:
    return _dense(blk["fc2"], _ffn_hidden(blk, x, cfg), cfg.compute_dtype)


def encode(params, src_ids: torch.Tensor, src_mask: torch.Tensor, cfg: BartConfig,
           attn_fn: AttnFn = layers.dot_product_attention) -> torch.Tensor:
    """Encoder stack -> [B, Ls, d] (post-LN, HF BartEncoder) on the ids'
    device; ``params`` one device's tree or a :class:`ShardedBart`."""
    return as_mesh(params, ShardedBart, cfg).encode(src_ids, src_mask, attn_fn)


def _lm_logits(params: Params, x: torch.Tensor, cfg: BartConfig) -> torch.Tensor:
    """Logits through the shared embedding, plus ``final_logits_bias`` (f32)."""
    return torch.matmul(x.to(cfg.compute_dtype), params["embed"].t()).float() \
        + params["final_logits_bias"]


def decode_full(params: Params, tgt_ids: torch.Tensor, enc_out: torch.Tensor,
                enc_mask: torch.Tensor, cfg: BartConfig,
                attn_fn: AttnFn = layers.dot_product_attention) -> torch.Tensor:
    """Teacher-forced decoder -> lm logits [B, Lt, V] f32 (causal self-mask)."""
    Lt = tgt_ids.shape[1]
    x = _embed(params, "dec", tgt_ids, 0, cfg)
    causal = torch.tril(torch.ones((Lt, Lt), dtype=torch.int32, device=x.device))[None, None]
    enc_attn = enc_mask[:, None, None, :]
    for blk in params["dec"]["layers"]:
        x = _ln(blk["ln1"], x + _mha(blk["self"], x, x, causal, cfg, attn_fn))
        x = _ln(blk["ln_x"], x + _mha(blk["cross"], x, enc_out, enc_attn, cfg, attn_fn))
        x = _ln(blk["ln2"], x + _ffn(blk, x, cfg))
    return _lm_logits(params, x, cfg)


# ---- cached single-step decode (generation) ----

def _init_self_caches(cfg: BartConfig, batch: int, max_new: int, device=None,
                      heads: Optional[int] = None) -> list:
    """Zeroed self-attention KV caches of ``max_new`` positions, per decoder
    layer, of ``heads`` heads (all by default)."""
    shape = (batch, heads or cfg.n_heads, max_new, cfg.d_model // cfg.n_heads)
    return [{"k": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
             "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=device)}
            for _ in range(cfg.n_dec_layers)]


def _init_cross_kv(params: Params, enc_out: torch.Tensor, cfg: BartConfig) -> list:
    """Cross-attention K/V of the encoder output for the heads ``params``
    holds, computed once per generation (the same at every step and for
    every beam of a row), kept contiguous so the per-step products read
    them without a copy."""
    dtype = cfg.compute_dtype
    return [{"k": _heads(_dense(blk["cross"]["k"], enc_out, dtype), cfg).contiguous(),
             "v": _heads(_dense(blk["cross"]["v"], enc_out, dtype), cfg).contiguous()}
            for blk in params["dec"]["layers"]]


def decode_step(params: Params, tok: torch.Tensor, step: int, self_caches: list,
                cross_kv: list, enc_mask: torch.Tensor, cfg: BartConfig,
                max_new: int) -> Tuple[torch.Tensor, list]:
    """One device's cached decoder step -> (logits [B, V] f32,
    self_caches). The new K/V row is written into the caches IN PLACE at
    ``step``; positions past ``step`` are masked (``max_new`` the caches'
    length). :meth:`ShardedBart.step_group` with the tree as its one shard."""
    logits = as_mesh(params, ShardedBart, cfg).step_group(
        [params], [tok], step, [self_caches],
        [{"kv": cross_kv, "mask": enc_mask[:, None, None, :]}])
    return logits, self_caches


def generate(params, src_ids: torch.Tensor, src_mask: torch.Tensor, cfg: BartConfig,
             max_new_tokens: int, num_beams: int = 1, length_penalty: float = 1.0,
             early_stopping: bool = False, min_length: int = 0,
             attn_fn: AttnFn = layers.dot_product_attention
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy (or beam) generation -> (tokens [B, T], lengths [B]); tokens
    after EOS are the pad id. ``attn_fn`` serves the encoder pass, where the
    long context is."""
    return as_mesh(params, ShardedBart, cfg).generate(
        src_ids, src_mask, max_new_tokens, attn_fn, num_beams=num_beams,
        length_penalty=length_penalty, early_stopping=early_stopping, min_length=min_length)


class ShardedBart(ShardedDecoder):
    """BART over a mesh's dp and tp axes (``models.sharded_decoder``): shard
    (i, j) is the tree of tp piece j (``shardings.bart_specs``) on device
    (dp=i, tp=j). q/k/v and ``fc1`` are column parallel (their biases
    split), ``o`` and ``fc2`` row parallel (their biases added once after
    the sum), the tied embedding's lookups sum and its logits gather over
    the vocabulary before ``final_logits_bias``."""

    SPLIT_KEYS = {"embed": "embed", "attn": "enc.layers.0.self.q", "ffn": "enc.layers.0.fc1"}

    def scan_ids(self):
        cfg = self.cfg
        return dict(start_id=cfg.decoder_start_id, eos_id=cfg.eos_id, pad_id=cfg.pad_id,
                    forced_first_id=cfg.forced_bos_id, forced_last_id=cfg.forced_eos_id)

    def _out(self, leaves, ctx_of, xs, part: str) -> list:
        """``o``/``fc2`` over the shards: row parallel, or whole on the first."""
        dtype = self.cfg.compute_dtype
        return row_out(self.split_over(part, len(xs)), ctx_of,
                       lambda x: _dense(leaves[0], x, dtype), lambda: list(leaves), xs, dtype,
                       part == "attn")

    def _mha(self, parts, q_in, kv_of, masks, fns) -> list:
        """Multi-head attention over the shards: shard j's heads of
        ``q_in[j]`` over ``kv_of(j)`` (keys, values), through ``fns[j]``."""
        cfg, dtype = self.cfg, self.cfg.compute_dtype

        def ctx(j: int) -> torch.Tensor:
            k, v = kv_of(j)
            return _merge(fns[j](_heads(_dense(parts[j]["q"], q_in[j], dtype), cfg), k, v,
                                 masks[j]), cfg)

        return self._out([p["o"] for p in parts], ctx, q_in, "attn")

    def _ffn(self, blks, xs) -> list:
        cfg = self.cfg
        f = self._out([b["fc2"] for b in blks], lambda j: _ffn_hidden(blks[j], xs[j], cfg), xs,
                      "ffn")
        return [_ln(b["ln2"], x + y) for b, x, y in zip(blks, xs, f)]

    def _embed(self, group, ids, branch: str, pos0: int) -> list:
        xs = layers.embed_tp([t["embed"] for t in group], ids,
                             self.split_over("embed", len(group)), self.cfg.compute_dtype)
        return [_embed_rest(t, branch, x, pos0, self.cfg) for t, x in zip(group, xs)]

    def _kv(self, a: Params, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg, dtype = self.cfg, self.cfg.compute_dtype
        return _heads(_dense(a["k"], x, dtype), cfg), _heads(_dense(a["v"], x, dtype), cfg)

    def encode_group(self, group, ids, masks, fns):
        xs = self._embed(group, ids, "enc", 0)
        attn_masks = [layers.pad_mask_to_attn(m) for m in masks]
        for blks in zip(*[t["enc"]["layers"] for t in group]):
            selfs = [b["self"] for b in blks]
            a = self._mha(selfs, xs, lambda j: self._kv(selfs[j], xs[j]), attn_masks, fns)
            xs = [_ln(b["ln1"], x + y) for b, x, y in zip(blks, xs, a)]
            xs = self._ffn(blks, xs)
        return xs

    def state_group(self, group, encs, masks, steps):
        return [{"kv": _init_cross_kv(t, e, self.cfg), "mask": m[:, None, None, :]}
                for t, e, m in zip(group, encs, masks)]

    def caches_group(self, rows, steps, devices):
        heads = self.heads(0)[1]
        return [_init_self_caches(self.cfg, rows, steps, dev, heads) for dev in devices]

    def step_group(self, group, toks, step, caches, states):
        cfg, dtype = self.cfg, self.cfg.compute_dtype
        n = len(group)
        dense = [layers.dot_product_attention] * n
        xs = self._embed(group, [t[:, None] for t in toks], "dec", step)      # [B, 1, d]
        steps = caches[0][0]["k"].shape[2]
        self_masks = [(torch.arange(steps, device=x.device) <= step).to(torch.int32)
                      [None, None, None] for x in xs]
        for l, blks in enumerate(zip(*[t["dec"]["layers"] for t in group])):
            selfs = [b["self"] for b in blks]

            def self_kv(j: int):
                c = caches[j][l]
                c["k"][:, :, step:step + 1], c["v"][:, :, step:step + 1] = \
                    self._kv(selfs[j], xs[j])
                return c["k"], c["v"]

            a = self._mha(selfs, xs, self_kv, self_masks, dense)
            xs = [_ln(b["ln1"], x + y) for b, x, y in zip(blks, xs, a)]
            a = self._mha([b["cross"] for b in blks], xs,
                          lambda j: (states[j]["kv"][l]["k"], states[j]["kv"][l]["v"]),
                          [s["mask"] for s in states], dense)
            xs = [_ln(b["ln_x"], x + y) for b, x, y in zip(blks, xs, a)]
            xs = self._ffn(blks, xs)
        logits = layers.vocab_logits_tp(lambda w, x: torch.matmul(x.to(dtype), w.t()).float(),
                                        [t["embed"] for t in group], xs,
                                        self.split_over("embed", n))
        return (logits + group[0]["final_logits_bias"])[:, 0]


# ---- weight import ----

def _dense_from(sd: Dict[str, torch.Tensor], prefix: str) -> Params:
    """HF ``nn.Linear`` ([out, in] weight) -> ``{"w": [in, out], "b"}``."""
    return {"w": sd[f"{prefix}.weight"].t(), "b": sd[f"{prefix}.bias"]}


def _ln_from(sd: Dict[str, torch.Tensor], prefix: str) -> Params:
    return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}


def _attn_from(sd: Dict[str, torch.Tensor], prefix: str) -> Params:
    return {"q": _dense_from(sd, f"{prefix}.q_proj"), "k": _dense_from(sd, f"{prefix}.k_proj"),
            "v": _dense_from(sd, f"{prefix}.v_proj"), "o": _dense_from(sd, f"{prefix}.out_proj")}


def from_state_dict(sd: Dict[str, Any], cfg: BartConfig, device=None) -> Params:
    """HF BART state dict (``BartModel`` or ``BartForConditionalGeneration``
    naming, the ``model.`` prefix stripped; numpy arrays or tensors) -> the
    port's tree on ``device``, quantized on the host from f32 for a
    quantized ``cfg.quant``."""
    return layers.place_tree(host_tree(sd, cfg), cfg.compute_dtype, device)


def host_tree(sd: Dict[str, Any], cfg: BartConfig) -> Params:
    """:func:`from_state_dict`'s tree on the host before placement."""
    sd = {(k[6:] if k.startswith("model.") else k): torch.as_tensor(v) for k, v in sd.items()}

    def branch(name: str, n_layers: int, cross: bool) -> Params:
        out: Params = {"pos": sd[f"{name}.embed_positions.weight"],
                       "ln_emb": _ln_from(sd, f"{name}.layernorm_embedding"), "layers": []}
        for i in range(n_layers):
            p = f"{name}.layers.{i}"
            blk: Params = {"self": _attn_from(sd, f"{p}.self_attn"),
                           "ln1": _ln_from(sd, f"{p}.self_attn_layer_norm"),
                           "fc1": _dense_from(sd, f"{p}.fc1"), "fc2": _dense_from(sd, f"{p}.fc2"),
                           "ln2": _ln_from(sd, f"{p}.final_layer_norm")}
            if cross:
                blk["cross"] = _attn_from(sd, f"{p}.encoder_attn")
                blk["ln_x"] = _ln_from(sd, f"{p}.encoder_attn_layer_norm")
            out["layers"].append(blk)
        return out

    bias = sd.get("final_logits_bias")
    tree = {
        "embed": sd["shared.weight"],
        "final_logits_bias": (torch.zeros(cfg.vocab_size) if bias is None
                              else bias.reshape(-1)),
        "enc": branch("encoder", cfg.n_enc_layers, cross=False),
        "dec": branch("decoder", cfg.n_dec_layers, cross=True),
    }
    return quant.quantize_tree(tree, "bart", cfg.quant)


def from_jax_params(flat: Dict[str, np.ndarray], cfg: BartConfig, device=None) -> Params:
    """The port's tree from the reference's BART parameter tree flattened to
    dotted keys (``embed``, ``final_logits_bias``, ``enc.layers.0.self.q.w``,
    ...; quantized leaves too), quantized on the host for a quantized
    ``cfg.quant``."""
    tree = quant.quantize_tree(layers.unflatten(flat), "bart", cfg.quant)
    return layers.place_tree(tree, cfg.compute_dtype, device)


def is_hf_bart_dir(path: str) -> bool:
    """A local HF BART checkpoint directory (config.json, model_type bart)."""
    cfg_path = os.path.join(path, "config.json")
    if not os.path.isdir(path) or not os.path.exists(cfg_path):
        return False
    try:
        with open(cfg_path) as f:
            return json.load(f).get("model_type") == "bart"
    except (OSError, ValueError, AttributeError):
        return True  # claim it; load_hf_dir surfaces the real error


def load_hf_dir(path: str, device=None, **config_overrides) -> Tuple[BartConfig, Params]:
    """(config, params on ``device``) from a local HF BART checkpoint
    directory: ``model.safetensors`` (the port's own reader), else
    ``pytorch_model.bin``."""
    from agent_tpu_torch.models.safetensors_io import load_hf_weights

    cfg = BartConfig.from_hf_json(os.path.join(path, "config.json"), **config_overrides)
    return cfg, from_state_dict(load_hf_weights(path), cfg, device)


def load_hf_flat(path: str, **config_overrides) -> Tuple[BartConfig, Dict[str, Any]]:
    """(config, the host tree as flat dotted keys): what a mesh places."""
    from agent_tpu_torch.models.safetensors_io import load_hf_weights

    cfg = BartConfig.from_hf_json(os.path.join(path, "config.json"), **config_overrides)
    return cfg, layers.flatten(host_tree(load_hf_weights(path), cfg), leaf=lambda v: v)


# ---- tokenizer ----

def hf_bpe(path: str):
    """The checkpoint's byte-level BPE (vocab.json + merges.txt), cached per
    directory by ``ByteLevelBPE.from_dir``."""
    from agent_tpu_torch.models.bpe import ByteLevelBPE

    if not os.path.exists(os.path.join(path, "vocab.json")):
        raise ValueError(f"BART checkpoint {path} has no vocab.json")
    return ByteLevelBPE.from_dir(path)


def encode_pad_batch(tok, texts, cfg: BartConfig, batch_buckets,
                     length_buckets) -> Tuple[np.ndarray, np.ndarray]:
    """``<s> pieces </s>`` per row -> (ids [B, L] int32, lengths [B] int32)
    with bucketed shapes; bucket truncation keeps the trailing ``</s>``."""
    from agent_tpu_torch.models.tokenizer import bucket_length

    max_len = cfg.max_src_len
    rows: List[List[int]] = [[cfg.bos_id] + tok.encode(t)[: max_len - 2] + [cfg.eos_id]
                             for t in texts]
    L = bucket_length(min(max(len(r) for r in rows), max_len), length_buckets)
    B = bucket_length(len(rows), batch_buckets)
    ids = np.full((B, L), cfg.pad_id, dtype=np.int32)
    lengths = np.zeros(B, dtype=np.int32)
    for r, row in enumerate(rows):
        if len(row) > L:
            row = row[: L - 1] + [cfg.eos_id]
        ids[r, : len(row)] = row
        lengths[r] = len(row)
    return ids, lengths
