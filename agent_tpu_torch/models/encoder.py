"""Transformer encoder classifier — the model behind ``map_classify_tpu``;
counterpart of ``agent_tpu.models.encoder``.

Weights are deterministic from the model id (the same arrays the JAX package
builds, :func:`init_params`) or loaded from a flat ``.npz`` checkpoint
(:func:`load_npz`); :func:`from_jax_params` turns either into an
:class:`Encoder` module, for serving or (``trainable=True``) for training,
and :meth:`Encoder.to_flat_numpy` turns a module back into the flat arrays.

``moe_experts`` > 0 gives every block the Switch MoE FFN
(:mod:`agent_tpu_torch.models.moe`) in place of the dense one; ``quant``
``int8`` or ``w8a16`` serves the blocks' matmuls quantized
(:mod:`agent_tpu_torch.models.quant`). The two compose.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from agent_tpu_torch.models import layers, moe, prng, quant
from agent_tpu_torch.models.layers import AttnFn

@dataclass(frozen=True)
class EncoderConfig:
    """Model hyperparameters (the JAX package's fields and defaults)."""

    vocab_size: int = 260          # byte vocab (256 bytes + specials)
    d_model: int = 256
    n_heads: int = 8
    n_layers: int = 4
    d_ff: int = 1024
    max_len: int = 2048
    n_classes: int = 1000
    dtype: str = "bfloat16"
    # "int8" (W8A8) or "w8a16" (weight only) serves the blocks' matmuls
    # quantized (models.quant).
    quant: str = "none"
    # pp > 1 (the reference's pipeline over a pp mesh axis) is not ported.
    pp: int = 1
    # moe_experts > 0 replaces each block's FFN with the Switch MoE layer.
    moe_experts: int = 0
    moe_capacity_factor: float = 1.25

    @property
    def compute_dtype(self) -> torch.dtype:
        return layers.compute_dtype(self.dtype)


def init_params(cfg: EncoderConfig, model_id: str = "classify-default") -> Dict[str, np.ndarray]:
    """Deterministic weights for ``model_id`` as flat dotted keys (float32
    numpy), equal leaf for leaf to ``agent_tpu.models.encoder.init_params``:
    with ``moe_experts`` > 0 each block's ``ffn`` is a ``moe`` subtree drawn
    from the block's key folded with 0x40E."""
    key = layers.seed_from(model_id)
    ks = prng.split(key, cfg.n_layers + 3)
    blocks = [layers.init_block(ks[i + 1], cfg.d_model, cfg.n_heads, cfg.d_ff)
              for i in range(cfg.n_layers)]
    mcfg = moe.moe_cfg_of(cfg)
    if mcfg is not None:
        for i, blk in enumerate(blocks):
            del blk["ffn"]
            blk["moe"] = moe.init_moe_ffn(prng.fold_in(ks[i + 1], 0x40E), mcfg)
    tree = {
        "embed": prng.normal(ks[0], (cfg.vocab_size, cfg.d_model)) * np.float32(0.02),
        "pos": layers.sinusoidal_positions(cfg.max_len, cfg.d_model),
        "blocks": blocks,
        "ln_f": layers.init_layer_norm(cfg.d_model),
        "head": layers.init_dense(ks[-1], cfg.d_model, cfg.n_classes),
    }
    return layers.flatten(tree)


def load_npz(path: str, cfg: EncoderConfig) -> Dict[str, np.ndarray]:
    """Params from a flat ``.npz`` (keys like ``blocks.0.attn.wq``); leaves
    absent from the file keep the deterministic init for id ``path``."""
    return layers.assign_from_npz(init_params(cfg, model_id=path), path)


class Encoder(nn.Module):
    """Embeddings + sinusoidal positions, pre-LN blocks, final LN, mean-pool
    over real tokens, linear head. Parameter names are the JAX tree's dotted
    keys. Serving form: matmul weights and embeddings in the compute dtype,
    frozen, ``pos`` a buffer. Training form (``trainable=True``): every leaf
    an f32 parameter with gradients, ``pos`` included (it is a trained leaf
    of the reference's tree), cast to the compute dtype at use."""

    def __init__(self, cfg: EncoderConfig, device=None, trainable: bool = False) -> None:
        super().__init__()
        self.cfg = cfg
        dtype = cfg.compute_dtype
        self.embed = layers.make_weight((cfg.vocab_size, cfg.d_model), dtype, device, trainable)
        pos = layers.make_weight((cfg.max_len, cfg.d_model), dtype, device, trainable)
        if trainable:
            self.pos = pos
        else:
            self.register_buffer("pos", pos.data)
        mcfg = moe.moe_cfg_of(cfg)
        self.blocks = nn.ModuleList(
            layers.EncoderBlock(cfg.d_model, cfg.n_heads, cfg.d_ff, dtype, device, trainable,
                                mcfg)
            for _ in range(cfg.n_layers))
        self.ln_f = layers.LayerNorm(cfg.d_model, device, trainable)
        self.head = layers.Dense(cfg.d_model, cfg.n_classes, dtype, device, trainable)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor,
                attn_fn: AttnFn = layers.dot_product_attention,
                remat: bool = False, with_aux: bool = False):
        """ids, mask [B, L] int (mask 1 = real token) -> logits [B, n_classes] f32.

        ``remat=True`` recomputes each block's activations in the backward
        instead of storing them (``torch.utils.checkpoint``, the reference's
        ``jax.checkpoint`` per block): less memory for one more forward.
        ``with_aux=True`` returns (logits, the blocks' mean Switch aux loss,
        0 for a dense model)."""
        dtype = self.cfg.compute_dtype
        L = ids.shape[1]
        x = self.embed.to(dtype)[ids.long()] + self.pos[:L].to(dtype)[None]
        attn_mask = layers.pad_mask_to_attn(mask)
        moe = with_aux and self.cfg.moe_experts > 0
        aux_total = 0.0
        for block in self.blocks:
            if remat:
                out = checkpoint(block, x, attn_mask, attn_fn, moe, use_reentrant=False)
            else:
                out = block(x, attn_mask, attn_fn, with_aux=moe)
            if moe:
                x, aux = out
                aux_total = aux_total + aux
            else:
                x = out
        x = self.ln_f(x)
        denom = mask.sum(dim=1, keepdim=True).clamp_min(1).float()
        pooled = (x.float() * mask[:, :, None]).sum(dim=1) / denom
        logits = self.head(pooled.to(dtype)).float()
        if with_aux:
            aux = aux_total / max(1, self.cfg.n_layers) if moe else logits.new_zeros(())
            return logits, aux
        return logits

    def to_flat_numpy(self) -> Dict[str, np.ndarray]:
        """The inverse of :func:`from_jax_params`: dotted key -> array (f32,
        a quantized model's int8 tables as int8)."""
        return {k: (v.detach().float() if v.is_floating_point() else v.detach()).cpu().numpy()
                for k, v in self.state_dict().items()}


def from_jax_params(flat: Dict[str, np.ndarray], cfg: EncoderConfig,
                    device: Optional[torch.device] = None,
                    trainable: bool = False) -> Encoder:
    """An :class:`Encoder` holding ``flat`` — the dotted-key layout of
    ``assign_from_npz`` (``init_params``, ``load_npz``, or a flattened JAX
    param tree, quantized or not) — in the serving form (cast to the
    compute dtype where the reference casts) or the training form (f32).
    A serving model of a quantized ``cfg.quant`` quantizes the f32 ``flat``
    on the host first; a training model trains float weights."""
    model = Encoder(cfg, device=device, trainable=trainable)
    flat, mode = quant.quantize_flat(flat, "encoder", "none" if trainable else cfg.quant)
    if mode is not None:
        quant.quantize_(model, mode)
    state = {k: torch.tensor(np.asarray(v)) for k, v in flat.items()}
    model.load_state_dict(state, strict=True)
    return model.train(trainable)


def topk_probs(logits: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over f32 softmax probabilities -> (values, indices) [B, k],
    descending, ties broken toward the lower index as ``lax.top_k`` does (a
    stable descending sort; ``torch.topk`` leaves tie order unspecified)."""
    probs = torch.softmax(logits.float(), dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def topk_rows(values: np.ndarray, indices: np.ndarray) -> list:
    """(values, indices) -> per-row ``[{"index", "score"}]``, in order."""
    return [
        [{"index": i, "score": s} for i, s in zip(idx_row, val_row)]
        for idx_row, val_row in zip(np.asarray(indices).tolist(),
                                    np.asarray(values).tolist())
    ]
