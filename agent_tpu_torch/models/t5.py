"""HF-T5-compatible seq2seq in PyTorch — counterpart of
``agent_tpu.models.t5``, the checkpoint family BASELINE.json names for the
summarize slot ("map_summarize.py T5-large seq2seq").

Faithful to ``transformers``' T5 as the reference is: RMSNorm (no mean
subtraction, no bias), pre-LN residual blocks, bucketed relative position
biases (learned in the first block of each stack and shared by the rest,
bidirectional in the encoder, causal in the decoder), unscaled attention,
ReLU or gated-GELU FFN per ``feed_forward_proj``, and an lm head tied to the
embedding with the ``d_model**-0.5`` output scale (or an untied head).

Weights are a nested dict named as the reference's tree
(:func:`from_state_dict`), on one device. Linear weights keep the HF
checkpoint's ``[out, in]`` layout and are applied with ``F.linear`` (the
reference transposes them to ``[in, out]`` for ``jnp.dot``: the same
product); they and the embedding are stored in the compute dtype, which is
the reference's cast at use done once. Norm weights and the relative bias
tables stay f32, as the reference reads them.

The encoder's self-attention goes through a kernel when the caller passes
one (``runtime.t5_attention_kernel()``, the CUDA T5 kernel on the card);
the decoder's keeps the dense bias path (its per-step Lq = 1 is outside the
kernel's contract). Generation runs on :mod:`agent_tpu_torch.models.decoding`
with dense KV caches written in place.

Over a mesh the weights are a :class:`ShardedT5` (``models.sharded_decoder``,
placed by ``shardings.t5_layout_specs``): rows over dp, heads, FFN columns
and the vocabulary over tp. The encoder's kernel runs once per shard with
that shard's heads and the relative bias table's head columns (the table
itself is replicated), and so does the decoder's causal bias; RMSNorms
replicate. One device's tree runs the same group code as the one shard.

Text needs the checkpoint's SentencePiece model and the ``sentencepiece``
package (:func:`hf_spm`), which raises an actionable error when absent; the
ids-level model path works without it.
"""

from __future__ import annotations

import functools
import json
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from agent_tpu_torch.models import layers, quant
from agent_tpu_torch.models.layers import NEG_INF, Params, compute_dtype
from agent_tpu_torch.models.sharded_decoder import ShardedDecoder, as_mesh, row_out

@dataclass(frozen=True)
class T5Config:
    """Mirror of the HF T5 ``config.json`` fields the forward needs."""

    vocab_size: int = 32128
    d_model: int = 512
    d_kv: int = 64              # per-head dim (decoupled from d_model in T5)
    n_heads: int = 8
    n_enc_layers: int = 6
    n_dec_layers: int = 6
    d_ff: int = 2048
    rel_buckets: int = 32
    rel_max_distance: int = 128
    gated_ffn: bool = False     # v1.1 "gated-gelu"; v1.0 is plain relu
    tie_word_embeddings: bool = True
    pad_id: int = 0
    eos_id: int = 1
    decoder_start_id: int = 0   # T5 starts decode from pad
    layer_norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    # "int8" (W8A8) or "w8a16" (weight only): attention, cross attention
    # and FFN matrices (models.quant); embeddings, norms, relative bias
    # tables and the lm head stay float.
    quant: str = "none"
    # The uniform serving-config view map_summarize reads off any family.
    max_src_len: int = 1024
    max_tgt_len: int = 1024

    @property
    def compute_dtype(self) -> torch.dtype:
        return compute_dtype(self.dtype)

    @classmethod
    def from_hf_json(cls, path: str, **overrides) -> "T5Config":
        try:
            with open(path) as f:
                hf = json.load(f)
        except json.JSONDecodeError as exc:
            raise RuntimeError(
                f"unreadable checkpoint config.json at {path}: {exc}"
            ) from exc
        if hf.get("model_type") not in (None, "t5"):
            raise RuntimeError(
                f"not a T5 checkpoint (model_type={hf.get('model_type')!r})"
            )
        proj = hf.get("feed_forward_proj", "relu")
        # A checkpoint served through the wrong activation would return
        # ok=true with wrong numerics: only the two T5 activations load.
        if proj not in ("relu", "gated-gelu"):
            raise RuntimeError(
                f"unsupported T5 feed_forward_proj={proj!r} "
                "(supported: 'relu', 'gated-gelu')"
            )
        fields = dict(
            vocab_size=hf["vocab_size"],
            d_model=hf["d_model"],
            d_kv=hf["d_kv"],
            n_heads=hf["num_heads"],
            n_enc_layers=hf["num_layers"],
            n_dec_layers=hf.get("num_decoder_layers", hf["num_layers"]),
            d_ff=hf["d_ff"],
            rel_buckets=hf.get("relative_attention_num_buckets", 32),
            rel_max_distance=hf.get("relative_attention_max_distance", 128),
            gated_ffn=proj.startswith("gated"),
            tie_word_embeddings=hf.get("tie_word_embeddings", True),
            pad_id=hf.get("pad_token_id", 0),
            eos_id=hf.get("eos_token_id", 1),
            decoder_start_id=hf.get(
                "decoder_start_token_id", hf.get("pad_token_id", 0)
            ),
            layer_norm_eps=hf.get("layer_norm_epsilon", 1e-6),
        )
        fields.update(overrides)
        return cls(**fields)


def _rms(w: torch.Tensor, x: torch.Tensor, eps: float) -> torch.Tensor:
    """T5LayerNorm: scale / rms, no mean subtraction, no bias; f32 stats."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (w * (x32 * torch.rsqrt(var + eps))).to(x.dtype)


def _dense(w, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Bias-free linear (T5 has no biases anywhere); w is HF's [out, in],
    or a quantized leaf of that layout."""
    if quant.leaf_mode(w) is not None:
        return quant.linear(w, x, dtype)
    return F.linear(x.to(dtype), w)


def _row_leaf(w) -> Params:
    """An ``[out, in]`` linear (a tensor or a quantized leaf of that layout)
    as a row-parallel leaf with an ``[in, out]`` table (``layers.row_parallel``)."""
    if quant.leaf_mode(w) is None:
        return {"w": w.t()}
    table = quant.TABLE_KEY[quant.leaf_mode(w)]
    return dict(w, **{table: w[table].t()})


def relative_position_bucket(relative_position: torch.Tensor, bidirectional: bool,
                             num_buckets: int, max_distance: int) -> torch.Tensor:
    """HF ``_relative_position_bucket``, the reference's arithmetic (f32 log,
    truncation toward zero). ``relative_position`` = key_pos − query_pos
    (an int tensor)."""
    rel = relative_position
    bucket = torch.zeros_like(rel)
    if bidirectional:
        num_buckets //= 2
        bucket = bucket + (rel > 0).to(rel.dtype) * num_buckets
        rel = rel.abs()
    else:
        rel = -torch.clamp_max(rel, 0)
    max_exact = num_buckets // 2
    is_small = rel < max_exact
    rel_f = torch.clamp_min(rel.float(), 1.0)
    large = max_exact + (
        torch.log(rel_f / max_exact) / float(np.log(max_distance / max_exact))
        * (num_buckets - max_exact)
    ).to(rel.dtype)
    large = torch.clamp_max(large, num_buckets - 1)
    return bucket + torch.where(is_small, rel, large)


@functools.lru_cache(maxsize=16)
def distance_buckets(bidirectional: bool, num_buckets: int, max_distance: int,
                     device: torch.device) -> torch.Tensor:
    """The bucket of every relative position in [-max_distance,
    max_distance] (index rel + max_distance), int64 on ``device``. The
    bucket saturates beyond ±max_distance, so this table clamped gives every
    position's bucket. Computed on the CPU, whose f32 arithmetic the tests
    hold equal to the reference's, whatever device then takes it."""
    rel = torch.arange(-max_distance, max_distance + 1, dtype=torch.int32)
    return relative_position_bucket(rel, bidirectional, num_buckets,
                                    max_distance).to(device=device, dtype=torch.long)


def _position_bias(rel_bias: torch.Tensor, q_pos: torch.Tensor, k_pos: torch.Tensor,
                   bidirectional: bool, cfg: T5Config) -> torch.Tensor:
    """[1, H, Lq, Lk] additive attention bias (f32)."""
    maxd = cfg.rel_max_distance
    rel = (k_pos[None, :] - q_pos[:, None]).clamp(-maxd, maxd) + maxd  # [Lq, Lk]
    buckets = distance_buckets(bool(bidirectional), cfg.rel_buckets, maxd, rel.device)
    return rel_bias.float()[buckets[rel.long()]].permute(2, 0, 1)[None]


def _pad_bias(mask: torch.Tensor) -> torch.Tensor:
    """[B, Lk] padding mask -> additive [B, 1, 1, Lk] f32 bias."""
    return torch.where(mask[:, None, None, :] > 0, 0.0, NEG_INF).float()


def _heads(t: torch.Tensor, cfg: T5Config) -> torch.Tensor:
    """[B, L, H·d_kv] -> [B, H, L, d_kv] (H: the heads a shard holds)."""
    B, L, _ = t.shape
    return t.view(B, L, -1, cfg.d_kv).transpose(1, 2)


def _merge(ctx: torch.Tensor, cfg: T5Config) -> torch.Tensor:
    """[B, H, L, d_kv] -> [B, L, H·d_kv]."""
    B, _, L, _ = ctx.shape
    return ctx.transpose(1, 2).reshape(B, L, -1)


def _softmax_ctx(q, k, v, bias, dtype) -> torch.Tensor:
    """UNSCALED scores (stored in the compute dtype, as the reference's
    einsum) + f32 ``bias``, softmax in f32, probabilities in the compute
    dtype, times V."""
    scores = torch.matmul(q, k.transpose(-1, -2)).float() + bias
    probs = torch.softmax(scores, dim=-1).to(dtype)
    return torch.matmul(probs, v)


def _attn(blk: Params, q_in, kv_in, bias, cfg: T5Config) -> torch.Tensor:
    """T5 attention with an additive ``bias`` (position bias and padding mask
    pre-combined, f32). blk = {q, k, v, o}."""
    dtype = cfg.compute_dtype
    q = _heads(_dense(blk["q"], q_in, dtype), cfg)
    k = _heads(_dense(blk["k"], kv_in, dtype), cfg)
    v = _heads(_dense(blk["v"], kv_in, dtype), cfg)
    return _dense(blk["o"], _merge(_softmax_ctx(q, k, v, bias, dtype), cfg), dtype)


def _ffn_hidden(blk: Params, x, cfg: T5Config) -> torch.Tensor:
    """The FFN's activation before ``wo`` (a shard's columns of it)."""
    dtype = cfg.compute_dtype
    if cfg.gated_ffn:
        # HF gated-gelu uses the tanh approximation.
        return F.gelu(_dense(blk["wi_0"], x, dtype).float(), approximate="tanh").to(dtype) \
            * _dense(blk["wi_1"], x, dtype)
    return torch.relu(_dense(blk["wi"], x, dtype))


def _ffn(blk: Params, x, cfg: T5Config) -> torch.Tensor:
    return _dense(blk["wo"], _ffn_hidden(blk, x, cfg), cfg.compute_dtype)


def encode(params, src_ids: torch.Tensor, src_mask: torch.Tensor,
           cfg: T5Config, kernel=None) -> torch.Tensor:
    """Encoder stack -> [B, Ls, d] on the ids' device; ``params`` one
    device's tree or a :class:`ShardedT5`.

    ``kernel`` is a T5 attention function with the signature of
    :func:`agent_tpu_torch.kernels.flash_attention.flash_attention_t5`
    (``runtime.t5_attention_kernel()``); it returns None for shapes it does
    not take, and the layer then takes the dense path with a bias built once.
    The shape gate is the same for every layer, so a decline in the first
    layer sends every layer to the dense path. Without a kernel every layer
    is dense."""
    return as_mesh(params, ShardedT5, cfg).encode(src_ids, src_mask, kernel)


def _lm_logits(params: Params, x: torch.Tensor, cfg: T5Config) -> torch.Tensor:
    dtype = cfg.compute_dtype
    if cfg.tie_word_embeddings:
        return F.linear(x * (cfg.d_model ** -0.5), params["embed"]).float()
    return F.linear(x.to(dtype), params["lm_head"]).float()


def _causal_rel_bias(params: Params, T: int, cfg: T5Config, device) -> torch.Tensor:
    """The decoder's [1, H, T, T] causal + relative bias (f32)."""
    pos = torch.arange(T, dtype=torch.int32, device=device)
    causal = torch.where(pos[None, :] <= pos[:, None], 0.0, NEG_INF).float()[None, None]
    return _position_bias(params["dec"]["rel_bias"], pos, pos, False, cfg) + causal


def decode_full(params: Params, tgt_ids: torch.Tensor, enc_out: torch.Tensor,
                enc_mask: torch.Tensor, cfg: T5Config) -> torch.Tensor:
    """Teacher-forced decoder -> lm logits [B, Lt, V] f32."""
    x = params["embed"][tgt_ids.long()]
    self_bias = _causal_rel_bias(params, tgt_ids.shape[1], cfg, x.device)
    cross_bias = _pad_bias(enc_mask)  # no positional bias on cross-attention
    for blk in params["dec"]["layers"]:
        h = _rms(blk["ln1"], x, cfg.layer_norm_eps)
        x = x + _attn(blk["attn"], h, h, self_bias, cfg)
        h = _rms(blk["ln_x"], x, cfg.layer_norm_eps)
        x = x + _attn(blk["cross"], h, enc_out, cross_bias, cfg)
        h = _rms(blk["ln2"], x, cfg.layer_norm_eps)
        x = x + _ffn(blk["ffn"], h, cfg)
    return _lm_logits(params, _rms(params["dec"]["ln_f"], x, cfg.layer_norm_eps), cfg)


# ---- cached single-step decode (generation) ----

def _init_self_caches(cfg: T5Config, batch: int, max_new: int, device,
                      heads: Optional[int] = None) -> list:
    shape = (batch, heads or cfg.n_heads, max_new, cfg.d_kv)
    return [{"k": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
             "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=device)}
            for _ in range(cfg.n_dec_layers)]


def _init_cross_kv(params: Params, enc_out: torch.Tensor, cfg: T5Config) -> list:
    """Cross-attention K/V of the heads ``params`` holds, computed once per
    generation (loop-invariant), contiguous so the per-step products read
    them without a copy."""
    dtype = cfg.compute_dtype
    return [{"k": _heads(_dense(blk["cross"]["k"], enc_out, dtype), cfg).contiguous(),
             "v": _heads(_dense(blk["cross"]["v"], enc_out, dtype), cfg).contiguous()}
            for blk in params["dec"]["layers"]]


def decode_step(params: Params, tok: torch.Tensor, step: int, self_caches: list,
                cross_kv: list, dec_bias: torch.Tensor, enc_mask_bias: torch.Tensor,
                cfg: T5Config) -> Tuple[torch.Tensor, list]:
    """One device's cached decoder step -> (logits [B, V] f32, self_caches).
    The new K/V row is written into the caches IN PLACE at ``step``;
    ``dec_bias`` is the causal relative bias [1, H, T, T] of the whole
    decode, of which row ``step`` is used (positions past ``step`` carry
    NEG_INF). :meth:`ShardedT5.step_group` with the tree as its one shard."""
    logits = as_mesh(params, ShardedT5, cfg).step_group(
        [params], [tok], step, [self_caches],
        [{"kv": cross_kv, "dec_bias": dec_bias, "mask_bias": enc_mask_bias}])
    return logits, self_caches


def generate(params, src_ids: torch.Tensor, src_mask: torch.Tensor,
             cfg: T5Config, max_new_tokens: int, num_beams: int = 1,
             length_penalty: float = 1.0, early_stopping: bool = False,
             min_length: int = 0, kernel=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy (or beam) generation on the decode engines. Returns (tokens
    [B, T], lengths [B]); tokens after EOS are the pad id. ``kernel`` routes
    the encoder's self-attention (see :func:`encode`)."""
    return as_mesh(params, ShardedT5, cfg).generate(
        src_ids, src_mask, max_new_tokens, kernel, num_beams=num_beams,
        length_penalty=length_penalty, early_stopping=early_stopping, min_length=min_length)


class ShardedT5(ShardedDecoder):
    """T5 over a mesh's dp and tp axes (``models.sharded_decoder``): shard
    (i, j) is the tree of tp piece j (``shardings.t5_layout_specs``) on
    device (dp=i, tp=j). Each shard's attentions use its heads (and its
    head columns of the relative bias tables, :func:`bias_columns`), ``o``
    and the FFN's ``wo`` sum over the shards (row parallel), the embedding's
    lookups sum and the lm head's logits gather over the vocabulary."""

    SPLIT_KEYS = {"embed": "embed", "attn": "enc.layers.0.attn.q", "ffn": "enc.layers.0.ffn.wo",
                  "lm_head": "lm_head"}

    def scan_ids(self):
        cfg = self.cfg
        return {"start_id": cfg.decoder_start_id, "eos_id": cfg.eos_id, "pad_id": cfg.pad_id}

    def _rel_bias(self, table: torch.Tensor, j: int) -> torch.Tensor:
        first, count = self.heads(j)
        return bias_columns(table, first, count)

    def _out(self, leaves, ctx_of, xs, part: str) -> list:
        """``o``/``wo`` over the shards: row parallel, or whole on the first."""
        dtype = self.cfg.compute_dtype
        return row_out(self.split_over(part, len(xs)), ctx_of,
                       lambda x: _dense(leaves[0], x, dtype),
                       lambda: [_row_leaf(w) for w in leaves], xs, dtype, part == "attn")

    def _ffn(self, blks, xs) -> list:
        cfg = self.cfg
        hs = [_rms(b["ln2"], x, cfg.layer_norm_eps) for b, x in zip(blks, xs)]
        return self._out([b["ffn"]["wo"] for b in blks],
                         lambda j: _ffn_hidden(blks[j]["ffn"], hs[j], cfg), xs, "ffn")

    def _embed(self, group, ids):
        return layers.embed_tp([t["embed"] for t in group], ids,
                               self.split_over("embed", len(group)), self.cfg.compute_dtype)

    def encode_group(self, group, ids, masks, fns):
        cfg = self.cfg
        dtype, eps = cfg.compute_dtype, cfg.layer_norm_eps
        L = ids[0].shape[1]
        xs = self._embed(group, ids)
        rel = [self._rel_bias(t["enc"]["rel_bias"], j) for j, t in enumerate(group)]
        mask4 = [m[:, None, None, :].to(torch.int32) for m in masks]
        kernels = list(fns)
        dense_bias = [None] * len(group)  # built only when the dense path is taken

        def context(j: int, a: Params, h: torch.Tensor) -> torch.Tensor:
            q = _heads(_dense(a["q"], h, dtype), cfg)
            k = _heads(_dense(a["k"], h, dtype), cfg)
            v = _heads(_dense(a["v"], h, dtype), cfg)
            ctx = None
            if kernels[j] is not None:
                ctx = kernels[j](q, k, v, mask4[j], rel[j], bidirectional=True,
                                 max_distance=cfg.rel_max_distance, scale=1.0)
                if ctx is None:  # the gate is the same for every layer
                    kernels[j] = None
            if ctx is None:
                if dense_bias[j] is None:
                    pos = torch.arange(L, dtype=torch.int32, device=h.device)
                    dense_bias[j] = (_position_bias(rel[j], pos, pos, True, cfg)
                                     + _pad_bias(masks[j]))
                ctx = _softmax_ctx(q, k, v, dense_bias[j], dtype)
            return _merge(ctx, cfg)

        for blks in zip(*[t["enc"]["layers"] for t in group]):
            hs = [_rms(b["ln1"], x, eps) for b, x in zip(blks, xs)]
            a = self._out([b["attn"]["o"] for b in blks],
                          lambda j: context(j, blks[j]["attn"], hs[j]), xs, "attn")
            xs = [x + y for x, y in zip(xs, a)]
            xs = [x + y for x, y in zip(xs, self._ffn(blks, xs))]
        return [_rms(t["enc"]["ln_f"], x, eps) for t, x in zip(group, xs)]

    def state_group(self, group, encs, masks, steps):
        out = []
        for j, (t, e) in enumerate(zip(group, encs)):
            dec = dict(t, dec=dict(t["dec"], rel_bias=self._rel_bias(t["dec"]["rel_bias"], j)))
            out.append({"kv": _init_cross_kv(t, e, self.cfg),
                        "dec_bias": _causal_rel_bias(dec, steps, self.cfg, e.device),
                        "mask_bias": _pad_bias(masks[j])})
        return out

    def caches_group(self, rows, steps, devices):
        heads = self.heads(0)[1]
        return [_init_self_caches(self.cfg, rows, steps, dev, heads) for dev in devices]

    def step_group(self, group, toks, step, caches, states):
        cfg = self.cfg
        dtype, eps = cfg.compute_dtype, cfg.layer_norm_eps
        xs = [x[:, None] for x in self._embed(group, toks)]           # [B, 1, d]

        def self_ctx(j: int, a: Params, h: torch.Tensor, cache: Params) -> torch.Tensor:
            q = _heads(_dense(a["q"], h, dtype), cfg)
            cache["k"][:, :, step:step + 1] = _heads(_dense(a["k"], h, dtype), cfg)
            cache["v"][:, :, step:step + 1] = _heads(_dense(a["v"], h, dtype), cfg)
            bias_row = states[j]["dec_bias"][:, :, step:step + 1]   # [1, H, 1, T]
            return _merge(_softmax_ctx(q, cache["k"], cache["v"], bias_row, dtype), cfg)

        def cross_ctx(j: int, c: Params, h: torch.Tensor, kv: Params) -> torch.Tensor:
            q = _heads(_dense(c["q"], h, dtype), cfg)
            return _merge(_softmax_ctx(q, kv["k"], kv["v"], states[j]["mask_bias"], dtype), cfg)

        for l, blks in enumerate(zip(*[t["dec"]["layers"] for t in group])):
            hs = [_rms(b["ln1"], x, eps) for b, x in zip(blks, xs)]
            a = self._out([b["attn"]["o"] for b in blks],
                          lambda j: self_ctx(j, blks[j]["attn"], hs[j], caches[j][l]), xs,
                          "attn")
            xs = [x + y for x, y in zip(xs, a)]
            hs = [_rms(b["ln_x"], x, eps) for b, x in zip(blks, xs)]
            a = self._out([b["cross"]["o"] for b in blks],
                          lambda j: cross_ctx(j, blks[j]["cross"], hs[j], states[j]["kv"][l]),
                          xs, "attn")
            xs = [x + y for x, y in zip(xs, a)]
            xs = [x + y for x, y in zip(xs, self._ffn(blks, xs))]
        xs = [_rms(t["dec"]["ln_f"], x, eps) for t, x in zip(group, xs)]
        if cfg.tie_word_embeddings:
            return layers.vocab_logits_tp(
                lambda w, x: F.linear(x * (cfg.d_model ** -0.5), w).float(),
                [t["embed"] for t in group], xs, self.split_over("embed", len(group)))[:, 0]
        return layers.vocab_logits_tp(lambda w, x: F.linear(x.to(dtype), w).float(),
                                      [t["lm_head"] for t in group], xs,
                                      self.split_over("lm_head", len(group)))[:, 0]


def bias_columns(table: torch.Tensor, first: int, count: int) -> torch.Tensor:
    """A shard's columns of a relative bias table [buckets, H]: its heads
    ``first .. first + count`` (the table itself when that is every head)."""
    if first == 0 and count == table.shape[-1]:
        return table
    return table[:, first:first + count]


# ---- weight import ----

def from_state_dict(sd: Dict[str, Any], cfg: T5Config, device=None) -> Params:
    """HF T5 state dict (``T5Model`` / ``T5ForConditionalGeneration``
    naming; numpy arrays or tensors, any float dtype) -> the port's
    parameter tree on ``device``: linear weights and the embedding in the
    compute dtype, norms and relative bias tables in f32. A quantized
    ``cfg.quant`` reads the tree to f32 on the host, quantizes its matrices
    (``quant.quantize_t5``) and then places it."""
    return layers.place_tree(host_tree(sd, cfg), cfg.compute_dtype, device)


def host_tree(sd: Dict[str, Any], cfg: T5Config) -> Params:
    """:func:`from_state_dict`'s tree on the host before placement: the
    checkpoint's tensors as they are, or quantized from f32 for a quantized
    ``cfg.quant``."""
    quantized = cfg.quant in quant.QUANTIZED_MODES

    def get(key: str) -> torch.Tensor:
        t = torch.as_tensor(sd[key])
        return t.float() if quantized else t

    def attn_from(prefix: str) -> Params:
        return {n: get(f"{prefix}.{n}.weight") for n in ("q", "k", "v", "o")}

    def ffn_from(prefix: str) -> Params:
        names = ("wi_0", "wi_1", "wo") if cfg.gated_ffn else ("wi", "wo")
        return {n: get(f"{prefix}.{n}.weight") for n in names}

    def branch(name: str, n_layers: int, cross: bool) -> Params:
        out: Params = {
            "rel_bias": get(f"{name}.block.0.layer.0.SelfAttention"
                            ".relative_attention_bias.weight"),
            "layers": [],
            "ln_f": get(f"{name}.final_layer_norm.weight"),
        }
        ff_idx = 2 if cross else 1
        for i in range(n_layers):
            p = f"{name}.block.{i}"
            blk: Params = {
                "attn": attn_from(f"{p}.layer.0.SelfAttention"),
                "ln1": get(f"{p}.layer.0.layer_norm.weight"),
                "ffn": ffn_from(f"{p}.layer.{ff_idx}.DenseReluDense"),
                "ln2": get(f"{p}.layer.{ff_idx}.layer_norm.weight"),
            }
            if cross:
                blk["cross"] = attn_from(f"{p}.layer.1.EncDecAttention")
                blk["ln_x"] = get(f"{p}.layer.1.layer_norm.weight")
            out["layers"].append(blk)
        return out

    params: Params = {
        "embed": get("shared.weight"),
        "enc": branch("encoder", cfg.n_enc_layers, cross=False),
        "dec": branch("decoder", cfg.n_dec_layers, cross=True),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = get("lm_head.weight")
    return quant.quantize_tree(params, "t5", cfg.quant)


def is_hf_t5_dir(path: str) -> bool:
    cfg_path = os.path.join(path, "config.json")
    if not os.path.isdir(path) or not os.path.exists(cfg_path):
        return False
    try:
        with open(cfg_path) as f:
            return json.load(f).get("model_type") == "t5"
    except (OSError, ValueError, AttributeError):
        return True  # claim it; load_hf_dir surfaces the real error


def load_hf_dir(path: str, device=None, **config_overrides) -> Tuple[T5Config, Params]:
    """(config, params on ``device``) from a local HF T5 checkpoint
    directory: ``model.safetensors`` (the port's own reader), else
    ``pytorch_model.bin`` (:func:`~agent_tpu_torch.models.safetensors_io.load_hf_weights`)."""
    from agent_tpu_torch.models.safetensors_io import load_hf_weights

    cfg = T5Config.from_hf_json(os.path.join(path, "config.json"), **config_overrides)
    return cfg, from_state_dict(load_hf_weights(path), cfg, device)


def load_hf_flat(path: str, **config_overrides) -> Tuple[T5Config, Dict[str, Any]]:
    """(config, the host tree as flat dotted keys): what a mesh places."""
    from agent_tpu_torch.models.safetensors_io import load_hf_weights

    cfg = T5Config.from_hf_json(os.path.join(path, "config.json"), **config_overrides)
    return cfg, layers.flatten(host_tree(load_hf_weights(path), cfg), leaf=lambda v: v)


# ---- tokenizer (gated on sentencepiece) ----

@functools.lru_cache(maxsize=8)
def _load_spm(model_path: str, mtime: float):
    import sentencepiece as spm

    sp = spm.SentencePieceProcessor()
    sp.Load(model_path)
    return sp


def hf_spm(path: str):
    """The checkpoint's SentencePiece tokenizer (``spiece.model``), cached
    per (file, mtime). Needs the ``sentencepiece`` package: a clear,
    actionable error when it is absent."""
    try:
        import sentencepiece  # noqa: F401
    except ImportError as exc:
        raise RuntimeError(
            "serving a T5 checkpoint's text requires the sentencepiece "
            "package (pip install sentencepiece); the ids-level model path "
            "works without it"
        ) from exc
    model_path = os.path.join(path, "spiece.model")
    if not os.path.exists(model_path):
        raise ValueError(f"T5 checkpoint {path} has no spiece.model")
    model_path = os.path.abspath(model_path)
    return _load_spm(model_path, os.path.getmtime(model_path))


def encode_pad_batch(sp, texts, cfg: T5Config, batch_buckets,
                     length_buckets) -> Tuple[np.ndarray, np.ndarray]:
    """``pieces </s>`` per row (the HF T5 tokenizer's convention) -> (ids
    [B, L] int32, lengths [B] int32) with bucketed static shapes; bucket
    truncation keeps the trailing ``</s>``."""
    from agent_tpu_torch.models.tokenizer import bucket_length

    max_len = cfg.max_src_len
    rows: List[List[int]] = [sp.EncodeAsIds(t)[: max_len - 1] + [cfg.eos_id] for t in texts]
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

