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
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from agent_tpu_torch.models import layers, prng
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
    # The reference's int8 serving modes; this port serves "none" only and
    # map_summarize rejects the others.
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
    ``init_params``/``load_npz`` or a flattened JAX param tree — cast to the
    compute dtype where the reference casts at use."""
    model = Seq2Seq(cfg, device=device)
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


def _decode_step(model: Seq2Seq, tok: torch.Tensor, step: int, enc_kv: List[layers.KV],
                 enc_mask: torch.Tensor, caches: list) -> Tuple[torch.Tensor, list]:
    """One decoder step at scalar position ``step`` over the KV caches
    (written in place) -> (logits [B, V] f32, caches)."""
    cfg = model.cfg
    dtype = cfg.compute_dtype
    x = model.embed[tok.long()][:, None, :] + model.pos[step:step + 1].to(dtype)[None]
    positions = torch.arange(cfg.max_tgt_len, device=x.device)
    self_mask = (positions <= step).to(torch.int32)[None, None, None, :]
    enc_attn_mask = enc_mask[:, None, None, :]
    for block, kv, cache in zip(model.dec, enc_kv, caches):
        x = block(x, self_mask, kv, enc_attn_mask, cache, step)
    x = model.ln_dec(x)[:, 0]
    return torch.matmul(x.to(dtype), model.embed.t()).float(), caches


def greedy_generate(model: Seq2Seq, src_ids: torch.Tensor, src_mask: torch.Tensor,
                    max_new_tokens: int, min_length: int = 0,
                    attn_fn: AttnFn = layers.dot_product_attention
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy decode -> (tokens [B, max_new_tokens], lengths [B]); tokens
    after EOS are PAD."""
    from agent_tpu_torch.models.decoding import greedy_scan

    B = src_ids.shape[0]
    enc_out = encode(model, src_ids, src_mask, attn_fn)
    enc_kv = cross_kv(model, enc_out)

    def step_fn(tok, step, caches):
        return _decode_step(model, tok, step, enc_kv, src_mask, caches)

    return greedy_scan(step_fn, empty_cache(model.cfg, B, enc_out.device), B,
                       max_new_tokens, start_id=BOS_ID, eos_id=EOS_ID, pad_id=PAD_ID,
                       min_length=min_length, device=enc_out.device)


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
