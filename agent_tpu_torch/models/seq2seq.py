"""Encoder-decoder seq2seq — the in-house family behind ``map_summarize``;
counterpart of ``agent_tpu.models.seq2seq``.

Weights are deterministic from the model id (the same arrays the JAX package
builds, :func:`init_params`) or loaded from a flat ``.npz``
(:func:`load_npz`); :func:`from_jax_params` turns either into a
:class:`Seq2Seq` module holding them in the serving form. The encoder runs
once per request with the caller's attention function (the flash kernel on
the card); the decoder then steps over a KV cache of ``max_tgt_len``
positions per layer, written in place at each step, with dense attention as
the reference's decoder has. The cross-attention keys and values of the
encoder output are the same at every step, so they are computed once per
generation (the reference recomputes them inside its decode loop; the
values are the same).

For the continuous-batching engine (``decoding.ContinuousBatcher``) the
decode step also takes a [B] vector of per-row positions and a paged KV
pool (:func:`make_positional_step`, :func:`make_cache_factory`,
:func:`make_paged_cache_factory`); there the cross-attention keys and
values are computed once per request, when it joins the running batch.

Over a mesh the model is a :class:`ShardedSeq2Seq` (``models.sharded_decoder``):
rows over dp, Megatron-split weights over tp, each tp shard's KV cache
holding its heads. Its group code is the only decoder body: a one-device
:class:`Seq2Seq` runs it as the one shard of its device. The continuous
engine runs on replica 0's tp group (``make_*_cache_factory(shards=)``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from agent_tpu_torch.models import layers, prng, quant
from agent_tpu_torch.models.layers import AttnFn
from agent_tpu_torch.models.sharded_decoder import ShardedDecoder, as_mesh
from agent_tpu_torch.models.tokenizer import BOS_ID, EOS_ID, PAD_ID

@dataclass(frozen=True)
class Seq2SeqConfig:
    """Model hyperparameters (the JAX package's fields and defaults)."""

    vocab_size: int = 260
    d_model: int = 256
    n_heads: int = 8
    n_enc_layers: int = 4
    n_dec_layers: int = 4
    d_ff: int = 1024
    max_src_len: int = 1024
    max_tgt_len: int = 130
    dtype: str = "bfloat16"
    # "int8" (W8A8) or "w8a16" (weight only): every block's matmuls, in the
    # encoder and in every decode step (models.quant).
    quant: str = "none"

    @property
    def compute_dtype(self) -> torch.dtype:
        return layers.compute_dtype(self.dtype)


def init_params(cfg: Seq2SeqConfig, model_id: str = "summarize-default") -> Dict[str, np.ndarray]:
    """Deterministic weights for ``model_id`` as flat dotted keys (float32
    numpy), equal leaf for leaf to ``agent_tpu.models.seq2seq.init_params``."""
    key = layers.seed_from(model_id)
    n = cfg.n_enc_layers + cfg.n_dec_layers
    ks = prng.split(key, n + 3)
    max_len = max(cfg.max_src_len, cfg.max_tgt_len)
    tree = {
        "embed": prng.normal(ks[0], (cfg.vocab_size, cfg.d_model)) * np.float32(0.02),
        "pos": layers.sinusoidal_positions(max_len, cfg.d_model),
        "enc": [layers.init_block(ks[1 + i], cfg.d_model, cfg.n_heads, cfg.d_ff)
                for i in range(cfg.n_enc_layers)],
        "dec": [layers.init_block(ks[1 + cfg.n_enc_layers + i], cfg.d_model, cfg.n_heads,
                                  cfg.d_ff, cross=True)
                for i in range(cfg.n_dec_layers)],
        "ln_enc": layers.init_layer_norm(cfg.d_model),
        "ln_dec": layers.init_layer_norm(cfg.d_model),
    }
    return layers.flatten(tree)


def load_npz(path: str, cfg: Seq2SeqConfig) -> Dict[str, np.ndarray]:
    """Params from a flat ``.npz`` (keys like ``dec.0.xattn.wq``); leaves
    absent from the file keep the deterministic init for id ``path``."""
    return layers.assign_from_npz(init_params(cfg, model_id=path), path)


class Seq2Seq(nn.Module):
    """Embeddings + sinusoidal positions, pre-LN encoder and decoder blocks,
    final layer norms, and logits through the transposed embedding (tied,
    no head matrix). Parameter names are the JAX tree's dotted keys; matmul
    weights and embeddings in the compute dtype, frozen; ``pos`` a buffer."""

    def __init__(self, cfg: Seq2SeqConfig, device=None) -> None:
        super().__init__()
        self.cfg = cfg
        dtype = cfg.compute_dtype
        self.embed = layers.make_weight((cfg.vocab_size, cfg.d_model), dtype, device, False)
        max_len = max(cfg.max_src_len, cfg.max_tgt_len)
        self.register_buffer("pos", torch.empty((max_len, cfg.d_model), dtype=dtype,
                                                device=device))
        self.enc = nn.ModuleList(
            layers.EncoderBlock(cfg.d_model, cfg.n_heads, cfg.d_ff, dtype, device)
            for _ in range(cfg.n_enc_layers))
        self.dec = nn.ModuleList(
            layers.DecoderBlock(cfg.d_model, cfg.n_heads, cfg.d_ff, dtype, device)
            for _ in range(cfg.n_dec_layers))
        self.ln_enc = layers.LayerNorm(cfg.d_model, device)
        self.ln_dec = layers.LayerNorm(cfg.d_model, device)


def from_jax_params(flat: Dict[str, np.ndarray], cfg: Seq2SeqConfig,
                    device: Optional[torch.device] = None) -> Seq2Seq:
    """A :class:`Seq2Seq` holding ``flat`` — the dotted-key layout of
    ``init_params``/``load_npz`` or a flattened JAX param tree, quantized or
    not — cast to the compute dtype where the reference casts at use. A
    quantized ``cfg.quant`` quantizes the f32 ``flat`` on the host first."""
    model = Seq2Seq(cfg, device=device)
    flat, mode = quant.quantize_flat(flat, "seq2seq", cfg.quant)
    if mode is not None:
        quant.quantize_(model, mode)
    model.load_state_dict({k: torch.tensor(np.asarray(v)) for k, v in flat.items()},
                          strict=True)
    return model.eval()


class ShardedSeq2Seq(ShardedDecoder):
    """The seq2seq over a mesh's dp and tp axes (``models.sharded_decoder``):
    shard (i, j) is a :class:`Seq2Seq` on device (dp=i, tp=j) holding tp
    piece j of every leaf (``shardings.seq2seq_specs``). A block's
    attentions and FFN sum over the tp shards (``layers.encoder_block_tp``,
    ``layers.decoder_block_tp``), the tied embedding's lookups sum and its
    logits gather over the vocabulary."""

    SPLIT_KEYS = {"embed": "embed", "attn": "dec.0.attn.wq", "ffn": "dec.0.ffn.wi"}

    @classmethod
    def build_shard(cls, held, cfg: Seq2SeqConfig, device) -> Seq2Seq:
        model = Seq2Seq(cfg, device="meta")
        mode = quant.flat_mode(held)
        if mode is not None:
            quant.quantize_(model, mode)
        return layers.place_pieces(model, held, device).eval()

    def scan_ids(self):
        return {"start_id": BOS_ID, "eos_id": EOS_ID, "pad_id": PAD_ID}

    def _embed(self, group, ids):
        return layers.embed_tp([m.embed for m in group], ids,
                               self.split_over("embed", len(group)), self.cfg.compute_dtype)

    def encode_group(self, group, ids, masks, fns):
        dtype = self.cfg.compute_dtype
        L = ids[0].shape[1]
        xs = [x + m.pos[:L].to(dtype)[None] for m, x in zip(group, self._embed(group, ids))]
        attn_masks = [layers.pad_mask_to_attn(m) for m in masks]
        for l in range(self.cfg.n_enc_layers):
            xs = layers.encoder_block_tp([m.enc[l] for m in group], xs, attn_masks, fns,
                                         self.split_over("attn", len(group)),
                                         self.split_over("ffn", len(group)))
        return [m.ln_enc(x) for m, x in zip(group, xs)]

    def state_group(self, group, encs, masks, steps):
        return [{"kv": cross_kv(m, e), "mask": mask[:, None, None, :]}
                for m, e, mask in zip(group, encs, masks)]

    def caches_group(self, rows, steps, devices):
        heads = self.heads(0)[1]
        return [empty_cache(self.cfg, rows, dev, heads) for dev in devices]

    def step_group(self, group, toks, step, caches, states):
        """One decoder step over the caches (written in place) of one tp
        group. ``step`` is the scalar position of every row (the scan
        decode), or a [R] tensor of per-row positions (the continuous
        engine's slots, each at its own depth: per-row position embedding,
        causal mask and cache write). ``caches[j]`` is shard j's dense
        per-layer list (:func:`empty_cache`) or its paged ``{"table": [R,
        MAXB], "layers": [{"k", "v"}: [NB, H, BS, E]]}``
        (:func:`make_paged_cache_factory`), which needs the vector
        ``step``."""
        from agent_tpu_torch.parallel import collectives

        cfg = self.cfg
        dtype = cfg.compute_dtype
        paged = isinstance(caches[0], dict) and "table" in caches[0]
        vector = isinstance(step, torch.Tensor)
        if paged and not vector:
            raise ValueError("paged KV caches require per-row vector positions (the "
                             "continuous-batching step); scan decode uses dense caches")
        devs = [t.device for t in toks]
        steps = collectives.broadcast(step, devs) if vector else [step] * len(group)
        xs, self_masks = [], []
        for m, x, st in zip(group, self._embed(group, toks), steps):
            positions = torch.arange(cfg.max_tgt_len, device=x.device)
            x = x[:, None, :]
            if vector:
                # A row frozen past the table's end reads its last row, as the
                # reference's clamped gather; its output is discarded.
                xs.append(x + m.pos[st.long().clamp(max=m.pos.shape[0] - 1)].to(dtype)[:, None, :])
                self_masks.append((positions[None, :] <= st[:, None]).to(torch.int32)
                                  [:, None, None, :])
            else:
                xs.append(x + m.pos[st:st + 1].to(dtype)[None])
                self_masks.append((positions <= st).to(torch.int32)[None, None, None, :])
        tables = [c["table"] if paged else None for c in caches]
        per_layer = [c["layers"] if paged else c for c in caches]
        for l in range(cfg.n_dec_layers):
            xs = layers.decoder_block_tp(
                [m.dec[l] for m in group], xs, self_masks, [s["kv"][l] for s in states],
                [s["mask"] for s in states], [c[l] for c in per_layer], steps, tables,
                self.split_over("attn", len(group)), self.split_over("ffn", len(group)))
        xs = [m.ln_dec(x)[:, 0] for m, x in zip(group, xs)]
        return layers.vocab_logits_tp(lambda w, x: torch.matmul(x.to(dtype), w.t()).float(),
                                      [m.embed for m in group], xs,
                                      self.split_over("embed", len(group)))


def _mesh(model) -> ShardedSeq2Seq:
    """``model`` over its mesh: itself, or one device's module as one shard."""
    return as_mesh(model, ShardedSeq2Seq, getattr(model, "cfg", None))


def encode(model, src_ids: torch.Tensor, src_mask: torch.Tensor,
           attn_fn: AttnFn = layers.dot_product_attention) -> torch.Tensor:
    """Encoder stack over ids, mask [B, Ls] -> [B, Ls, d] on the ids'
    device; ``model`` a :class:`Seq2Seq` or a :class:`ShardedSeq2Seq`.
    ``attn_fn`` serves the encoder only (the kernel path, or ring attention
    on an sp mesh); decode steps attend over the cache densely."""
    return _mesh(model).encode(src_ids, src_mask, attn_fn)


def empty_cache(cfg: Seq2SeqConfig, batch: int, device=None,
                heads: Optional[int] = None) -> List[Dict[str, torch.Tensor]]:
    """The decoder's KV caches: per layer ``k``/``v`` [B, heads (all by
    default), max_tgt_len, E]."""
    shape = (batch, heads or cfg.n_heads, cfg.max_tgt_len, cfg.d_model // cfg.n_heads)
    return [{"k": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
             "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=device)}
            for _ in range(cfg.n_dec_layers)]


def cross_kv(model: Seq2Seq, enc_out: torch.Tensor) -> List[layers.KV]:
    """Each decoder layer's cross-attention keys and values of ``enc_out``
    (cast to the compute dtype) for the heads ``model`` holds, contiguous so
    the per-step products read them without a copy."""
    enc_out = enc_out.to(model.cfg.compute_dtype)
    return [tuple(t.contiguous() for t in block.xattn.kv(enc_out)) for block in model.dec]


def _decode_step(model: Seq2Seq, tok: torch.Tensor, step, enc_kv: List[layers.KV],
                 enc_mask: torch.Tensor, caches) -> Tuple[torch.Tensor, Any]:
    """One device's decoder step over its KV caches (written in place) ->
    (logits [B, V] f32, caches): :meth:`ShardedSeq2Seq.step_group` with the
    model as its one shard. ``enc_mask`` [B, Ls]."""
    logits = _mesh(model).step_group([model], [tok], step, [caches],
                                     [{"kv": enc_kv, "mask": enc_mask[:, None, None, :]}])
    return logits, caches


def greedy_generate(model, src_ids: torch.Tensor, src_mask: torch.Tensor,
                    max_new_tokens: int, min_length: int = 0,
                    attn_fn: AttnFn = layers.dot_product_attention
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy decode -> (tokens [B, max_new_tokens], lengths [B]); tokens
    after EOS are PAD."""
    return _mesh(model).generate(src_ids, src_mask, max_new_tokens, attn_fn,
                                 min_length=min_length)


def beam_generate(model, src_ids: torch.Tensor, src_mask: torch.Tensor,
                  max_new_tokens: int, num_beams: int = 4, length_penalty: float = 1.0,
                  early_stopping: bool = False, min_length: int = 0,
                  attn_fn: AttnFn = layers.dot_product_attention,
                  cache_reorder: str = "delta") -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam-search decode (HF ``BeamSearchScorer`` semantics, see
    ``decoding.beam_scan``): beams flatten into the batch, B·K rows.
    Returns (tokens [B, max_new_tokens], lengths [B])."""
    return _mesh(model).generate(src_ids, src_mask, max_new_tokens, attn_fn,
                                 num_beams=num_beams, length_penalty=length_penalty,
                                 early_stopping=early_stopping, min_length=min_length,
                                 cache_reorder=cache_reorder)


def greedy_generate_from_encoded(model, enc_out: torch.Tensor, src_mask: torch.Tensor,
                                 max_new_tokens: int, min_length: int = 0
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy decode from an encoder output computed elsewhere (the decode
    half of ``summarize_encode`` -> ``summarize_decode``): ``enc_out`` [B,
    Ls, d] in any float type, cast to the compute dtype; on a mesh its rows
    split over dp when they divide it. ``greedy_generate`` is
    :func:`encode` followed by this."""
    mesh = _mesh(model)
    encs, masks = mesh.encoded_parts(enc_out, src_mask)
    return mesh.decode(encs, masks, max_new_tokens, min_length=min_length)


class PositionalStep:
    """The continuous engine's step (``decoding.PositionalStepFn``):
    ``(tok [R], pos [R], caches, enc_kv, enc_mask [R, Ls]) -> (logits [R,
    V] f32, caches)``, with the encoder state an argument because each slot
    joins with its own. :meth:`encoder_state` turns joining rows' encoder
    output [n, Ls, d] (f32 from the prefill) into that state: each decoder
    layer's cross-attention keys and values [n, H, Ls, E], computed once
    when the request joins (the reference projects its stored encoder
    output again every step; the values are the same).

    On a mesh it runs on replica 0's tp group: the state and the caches are
    one per tp shard (its heads), the tokens, positions and mask live on the
    group's first device and go to each shard's."""

    def __init__(self, model) -> None:
        self.model = model
        self.mesh = _mesh(model)
        self.group, self.devices = self.mesh.group(0), self.mesh.devices(0)
        self.one = len(self.group) == 1

    def encoder_state(self, enc_rows: torch.Tensor):
        from agent_tpu_torch.parallel import collectives

        states = [cross_kv(m, e) for m, e in zip(self.group,
                                                  collectives.broadcast(enc_rows, self.devices))]
        return states[0] if self.one else states

    def __call__(self, tok, pos_rows, caches, enc_kv, enc_mask):
        from agent_tpu_torch.parallel import collectives

        parts = [caches] if self.one else caches.get("shards") if isinstance(caches, dict) \
            else caches
        kvs = [enc_kv] if self.one else enc_kv
        masks = collectives.broadcast(enc_mask[:, None, None, :], self.devices)
        logits = self.mesh.step_group(self.group, collectives.broadcast(tok, self.devices),
                                      pos_rows, parts,
                                      [{"kv": kv, "mask": m} for kv, m in zip(kvs, masks)])
        return logits, caches


def make_positional_step(model) -> PositionalStep:
    return PositionalStep(model)


def _engine_group(shards: Optional[ShardedSeq2Seq]):
    """(devices, heads each) of the engine's tp group on a mesh of more
    than one tp shard, else None (one device's caches)."""
    if shards is None or shards.tp == 1:
        return None
    return shards.devices(0), shards.heads(0)[1]


def make_cache_factory(cfg: Seq2SeqConfig, device=None, shards: Optional[ShardedSeq2Seq] = None):
    """``rows -> empty dense KV caches`` for the continuous engine: one
    device's per-layer list, or with ``shards`` on tp one such list per tp
    shard of replica 0, on its device, with its heads."""
    group = _engine_group(shards)

    def factory(rows: int):
        if group is None:
            return empty_cache(cfg, rows, device)
        return [empty_cache(cfg, rows, dev, group[1]) for dev in group[0]]

    return factory


def make_paged_cache_factory(cfg: Seq2SeqConfig, block_size: int = 16, pool_blocks: int = 0,
                             device=None, shards: Optional[ShardedSeq2Seq] = None):
    """``rows -> paged KV caches`` for the continuous engine: per decoder
    layer one pool of ``pool_blocks`` blocks [NB, H, block_size, E] shared
    by every row, and a block table [rows, ceil(max_tgt_len / block_size)]
    from a row's logical block to its pool block. Pool block 0 is the trash
    block, so ``pool_blocks`` counts one block no row can hold; 0 sizes the
    pool to the dense layout's memory (``rows * MAXB + 1``).

    With ``shards`` on tp: ``{"table": [rows, MAXB], "shards": [{"table",
    "layers"}, ...]}``, one pool per tp shard of replica 0 with its heads on
    its device, all of ``pool_blocks`` blocks under the one block table
    (copied to each shard's device): block b of every shard holds the same
    positions, each shard its own heads."""
    bs = int(block_size)
    if bs < 1:
        raise ValueError("block_size must be >= 1")
    maxb = -(-cfg.max_tgt_len // bs)
    d_head = cfg.d_model // cfg.n_heads
    group = _engine_group(shards)

    def pools(nb: int, heads: int, dev) -> list:
        shape = (nb, heads, bs, d_head)
        return [{"k": torch.zeros(shape, dtype=cfg.compute_dtype, device=dev),
                 "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=dev)}
                for _ in range(cfg.n_dec_layers)]

    def factory(rows: int) -> dict:
        nb = int(pool_blocks) or rows * maxb + 1
        if nb < maxb + 1:
            raise ValueError(f"pool_blocks={nb} cannot seat one max-length row "
                             f"({maxb} blocks + trash)")
        if group is None:
            return {"table": torch.zeros((rows, maxb), dtype=torch.int64, device=device),
                    "layers": pools(nb, cfg.n_heads, device)}
        devs, heads = group
        table = torch.zeros((rows, maxb), dtype=torch.int64, device=devs[0])
        return {"table": table,
                "shards": [{"table": table.to(dev), "layers": pools(nb, heads, dev)}
                           for dev in devs]}

    return factory
