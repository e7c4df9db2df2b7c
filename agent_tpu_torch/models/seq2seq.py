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
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from agent_tpu_torch.models import layers, prng, quant
from agent_tpu_torch.models.layers import AttnFn
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


def encode(model: Seq2Seq, src_ids: torch.Tensor, src_mask: torch.Tensor,
           attn_fn: AttnFn = layers.dot_product_attention) -> torch.Tensor:
    """Encoder stack over ids, mask [B, Ls] -> [B, Ls, d]. ``attn_fn``
    serves the encoder only (the kernel path, or ring attention on an sp
    mesh); decode steps attend over the cache densely."""
    dtype = model.cfg.compute_dtype
    L = src_ids.shape[1]
    x = model.embed[src_ids.long()] + model.pos[:L].to(dtype)[None]
    attn_mask = layers.pad_mask_to_attn(src_mask)
    for block in model.enc:
        x = block(x, attn_mask, attn_fn)
    return model.ln_enc(x)


def empty_cache(cfg: Seq2SeqConfig, batch: int, device=None) -> List[Dict[str, torch.Tensor]]:
    """The decoder's KV caches: per layer ``k``/``v`` [B, H, max_tgt_len, E]."""
    shape = (batch, cfg.n_heads, cfg.max_tgt_len, cfg.d_model // cfg.n_heads)
    return [{"k": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
             "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=device)}
            for _ in range(cfg.n_dec_layers)]


def cross_kv(model: Seq2Seq, enc_out: torch.Tensor) -> List[layers.KV]:
    """Each decoder layer's cross-attention keys and values of ``enc_out``,
    contiguous so the per-step products read them without a copy."""
    return [tuple(t.contiguous() for t in block.xattn.kv(enc_out)) for block in model.dec]


def _decode_step(model: Seq2Seq, tok: torch.Tensor, step, enc_kv: List[layers.KV],
                 enc_mask: torch.Tensor, caches) -> Tuple[torch.Tensor, Any]:
    """One decoder step over the KV caches (written in place) -> (logits
    [B, V] f32, caches).

    ``step`` is the scalar position of every row (the scan decode), or a
    [B] tensor of per-row positions (the continuous engine's slots, each at
    its own depth: per-row position embedding, causal mask and cache
    write). ``caches`` is the dense per-layer list (:func:`empty_cache`) or
    the paged ``{"table": [B, MAXB], "layers": [{"k", "v"}: [NB, H, BS,
    E]]}`` (:func:`make_paged_cache_factory`), which needs the vector
    ``step``."""
    cfg = model.cfg
    dtype = cfg.compute_dtype
    paged = isinstance(caches, dict) and "table" in caches
    vector = isinstance(step, torch.Tensor)
    if paged and not vector:
        raise ValueError("paged KV caches require per-row vector positions (the "
                         "continuous-batching step); scan decode uses dense caches")
    table = caches["table"] if paged else None
    layer_caches = caches["layers"] if paged else caches
    x = model.embed[tok.long()][:, None, :]
    positions = torch.arange(cfg.max_tgt_len, device=x.device)
    if vector:
        # A row frozen past the table's end reads its last row, as the
        # reference's clamped gather; its output is discarded.
        x = x + model.pos[step.long().clamp(max=model.pos.shape[0] - 1)].to(dtype)[:, None, :]
        self_mask = (positions[None, :] <= step[:, None]).to(torch.int32)[:, None, None, :]
    else:
        x = x + model.pos[step:step + 1].to(dtype)[None]
        self_mask = (positions <= step).to(torch.int32)[None, None, None, :]
    enc_attn_mask = enc_mask[:, None, None, :]
    for block, kv, cache in zip(model.dec, enc_kv, layer_caches):
        x = block(x, self_mask, kv, enc_attn_mask, cache, step, table)
    x = model.ln_dec(x)[:, 0]
    return torch.matmul(x.to(dtype), model.embed.t()).float(), caches


def greedy_generate(model: Seq2Seq, src_ids: torch.Tensor, src_mask: torch.Tensor,
                    max_new_tokens: int, min_length: int = 0,
                    attn_fn: AttnFn = layers.dot_product_attention
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy decode -> (tokens [B, max_new_tokens], lengths [B]); tokens
    after EOS are PAD."""
    return greedy_generate_from_encoded(model, encode(model, src_ids, src_mask, attn_fn),
                                        src_mask, max_new_tokens, min_length)


def beam_generate(model: Seq2Seq, src_ids: torch.Tensor, src_mask: torch.Tensor,
                  max_new_tokens: int, num_beams: int = 4, length_penalty: float = 1.0,
                  early_stopping: bool = False, min_length: int = 0,
                  attn_fn: AttnFn = layers.dot_product_attention,
                  cache_reorder: str = "delta") -> Tuple[torch.Tensor, torch.Tensor]:
    """Beam-search decode (HF ``BeamSearchScorer`` semantics, see
    ``decoding.beam_scan``): beams flatten into the batch, B·K rows.
    Returns (tokens [B, max_new_tokens], lengths [B])."""
    from agent_tpu_torch.models.decoding import beam_scan

    B, K = src_ids.shape[0], num_beams
    enc_out = encode(model, src_ids, src_mask, attn_fn).repeat_interleave(K, dim=0)
    enc_mask = src_mask.repeat_interleave(K, dim=0)
    enc_kv = cross_kv(model, enc_out)

    def step_fn(tok, step, caches):
        return _decode_step(model, tok, step, enc_kv, enc_mask, caches)

    return beam_scan(step_fn, empty_cache(model.cfg, B * K, enc_out.device), B,
                     model.cfg.vocab_size, max_new_tokens, num_beams=K, start_id=BOS_ID,
                     eos_id=EOS_ID, pad_id=PAD_ID, length_penalty=length_penalty,
                     early_stopping=early_stopping, min_length=min_length,
                     cache_reorder=cache_reorder, device=enc_out.device)


def greedy_generate_from_encoded(model: Seq2Seq, enc_out: torch.Tensor, src_mask: torch.Tensor,
                                 max_new_tokens: int, min_length: int = 0
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy decode from an encoder output computed elsewhere (the decode
    half of ``summarize_encode`` -> ``summarize_decode``): ``enc_out`` [B,
    Ls, d] in any float type, cast to the compute dtype. ``greedy_generate``
    is :func:`encode` followed by this."""
    from agent_tpu_torch.models.decoding import greedy_scan

    B = enc_out.shape[0]
    enc_kv = cross_kv(model, enc_out.to(model.cfg.compute_dtype))

    def step_fn(tok, step, caches):
        return _decode_step(model, tok, step, enc_kv, src_mask, caches)

    return greedy_scan(step_fn, empty_cache(model.cfg, B, enc_out.device), B,
                       max_new_tokens, start_id=BOS_ID, eos_id=EOS_ID, pad_id=PAD_ID,
                       min_length=min_length, device=enc_out.device)


class PositionalStep:
    """The continuous engine's step (``decoding.PositionalStepFn``):
    ``(tok [R], pos [R], caches, enc_kv, enc_mask [R, Ls]) -> (logits [R,
    V] f32, caches)``, with the encoder state an argument because each slot
    joins with its own. :meth:`encoder_state` turns joining rows' encoder
    output [n, Ls, d] (f32 from the prefill) into that state: each decoder
    layer's cross-attention keys and values [n, H, Ls, E], computed once
    when the request joins (the reference projects its stored encoder
    output again every step; the values are the same)."""

    def __init__(self, model: Seq2Seq) -> None:
        self.model = model

    def encoder_state(self, enc_rows: torch.Tensor) -> List[layers.KV]:
        return cross_kv(self.model, enc_rows.to(self.model.cfg.compute_dtype))

    def __call__(self, tok, pos_rows, caches, enc_kv, enc_mask):
        return _decode_step(self.model, tok, pos_rows, enc_kv, enc_mask, caches)


def make_positional_step(model: Seq2Seq) -> PositionalStep:
    return PositionalStep(model)


def make_cache_factory(cfg: Seq2SeqConfig, device=None):
    """``rows -> empty dense KV caches`` for the continuous engine."""

    def factory(rows: int) -> List[Dict[str, torch.Tensor]]:
        return empty_cache(cfg, rows, device)

    return factory


def make_paged_cache_factory(cfg: Seq2SeqConfig, block_size: int = 16, pool_blocks: int = 0,
                             device=None):
    """``rows -> paged KV caches`` for the continuous engine: per decoder
    layer one pool of ``pool_blocks`` blocks [NB, H, block_size, E] shared
    by every row, and a block table [rows, ceil(max_tgt_len / block_size)]
    from a row's logical block to its pool block. Pool block 0 is the trash
    block, so ``pool_blocks`` counts one block no row can hold; 0 sizes the
    pool to the dense layout's memory (``rows * MAXB + 1``)."""
    bs = int(block_size)
    if bs < 1:
        raise ValueError("block_size must be >= 1")
    maxb = -(-cfg.max_tgt_len // bs)
    d_head = cfg.d_model // cfg.n_heads

    def factory(rows: int) -> dict:
        nb = int(pool_blocks) or rows * maxb + 1
        if nb < maxb + 1:
            raise ValueError(f"pool_blocks={nb} cannot seat one max-length row "
                             f"({maxb} blocks + trash)")
        shape = (nb, cfg.n_heads, bs, d_head)
        return {
            "table": torch.zeros((rows, maxb), dtype=torch.int64, device=device),
            "layers": [{"k": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
                        "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=device)}
                       for _ in range(cfg.n_dec_layers)],
        }

    return factory
