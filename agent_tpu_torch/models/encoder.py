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

Over a mesh (``from_jax_params(..., mesh=)``) the model is a
:class:`ShardedEncoder`: the batch's rows split over ``dp``, the weights
Megatron-split over ``tp`` (``parallel.shardings.encoder_specs``), the
experts over ``ep``; or, with ``pp``, a
:class:`~agent_tpu_torch.parallel.pipeline.PipelinedEncoder`.
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
    # pp > 1 runs the blocks through the GPipe pipeline over a dp × pp mesh
    # of the runtime's devices (parallel.pipeline), as the reference does.
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
        """ids, mask [B, L] int (mask 1 = real token) -> logits [B, n_classes] f32:
        :meth:`ShardedEncoder.forward` with this module as its one shard.

        ``remat=True`` recomputes each block's activations in the backward
        instead of storing them (``torch.utils.checkpoint``, the reference's
        ``jax.checkpoint`` per block): less memory for one more forward.
        ``with_aux=True`` returns (logits, the blocks' mean Switch aux loss,
        0 for a dense model)."""
        return ShardedEncoder.of(self).forward(ids, mask, attn_fn, remat, with_aux)

    def lookup(self, ids: torch.Tensor) -> torch.Tensor:
        """The token embeddings of ``ids`` from the whole table."""
        return self.embed.to(self.cfg.compute_dtype)[ids.long()]

    def add_positions(self, x: torch.Tensor) -> torch.Tensor:
        """Token embeddings [B, L, d] plus the positions: the blocks' input."""
        return x + self.pos[:x.shape[1]].to(self.cfg.compute_dtype)[None]

    def pool_logits(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """The blocks' output [B, L, d] -> final LN, the mean over real
        tokens, the head: logits [B, n_classes] f32 (this module's classes)."""
        x = self.ln_f(x)
        denom = mask.sum(dim=1, keepdim=True).clamp_min(1).float()
        pooled = (x.float() * mask[:, :, None]).sum(dim=1) / denom
        return self.head(pooled.to(self.cfg.compute_dtype)).float()

    def to_flat_numpy(self) -> Dict[str, np.ndarray]:
        """The inverse of :func:`from_jax_params`: dotted key -> array (f32,
        a quantized model's int8 tables as int8)."""
        return {k: (v.detach().float() if v.is_floating_point() else v.detach()).cpu().numpy()
                for k, v in self.state_dict().items()}


def from_jax_params(flat: Dict[str, np.ndarray], cfg: EncoderConfig,
                    device: Optional[torch.device] = None,
                    trainable: bool = False, mesh=None):
    """An :class:`Encoder` holding ``flat`` — the dotted-key layout of
    ``assign_from_npz`` (``init_params``, ``load_npz``, or a flattened JAX
    param tree, quantized or not) — in the serving form (cast to the
    compute dtype where the reference casts) or the training form (f32).
    A serving model of a quantized ``cfg.quant`` quantizes the f32 ``flat``
    on the host first; a training model trains float weights.

    With a ``mesh`` of several shards: a :class:`ShardedEncoder` (or, with
    a ``pp`` axis, a ``PipelinedEncoder``) over it, placed by the
    encoder's specs as the runtime places them (:func:`place`)."""
    if mesh is not None and mesh.size > 1:
        from agent_tpu_torch.parallel import shardings

        flat = quant.quantize_flat(flat, "encoder", "none" if trainable else cfg.quant)[0]
        specs = shardings.placement_specs(mesh.shape, flat, shardings.encoder_specs(cfg))
        return place(flat, specs, mesh, cfg, trainable)
    model = Encoder(cfg, device=device, trainable=trainable)
    flat, mode = quant.quantize_flat(flat, "encoder", "none" if trainable else cfg.quant)
    if mode is not None:
        quant.quantize_(model, mode)
    state = {k: torch.tensor(np.asarray(v)) for k, v in flat.items()}
    model.load_state_dict(state, strict=True)
    return model.train(trainable)


def meta_encoder(cfg: EncoderConfig, mode: Optional[str], trainable: bool) -> Encoder:
    """An :class:`Encoder` of ``cfg`` on the ``meta`` device (no memory),
    quantized to ``mode``: the frame a shard's pieces are placed into."""
    model = Encoder(cfg, device="meta", trainable=trainable)
    if mode is not None:
        quant.quantize_(model, mode)
    return model.train(trainable)


def place(flat: Dict[str, np.ndarray], specs: Dict[str, tuple], mesh, cfg: EncoderConfig,
          trainable: bool = False):
    """The encoder over ``mesh`` from host ``flat`` (quantized already for
    a quantized serving model) and its placement ``specs``: the GPipe
    pipeline when the mesh has ``pp``, else a :class:`ShardedEncoder`."""
    if mesh.shape.get("pp", 1) > 1:
        from agent_tpu_torch.parallel.pipeline import PipelinedEncoder

        return PipelinedEncoder(flat, cfg, mesh, trainable)
    return ShardedEncoder(flat, cfg, specs, mesh, trainable)


def _is_expert(key: str) -> bool:
    return ".moe.wi" in key or ".moe.wo" in key


class ShardedEncoder:
    """The encoder over a mesh's ``dp``, ``tp`` and ``ep`` axes, in one
    process (the reference's GSPMD program over ``encoder_param_specs``).

    Shard (i, j) — dp replica i, tp shard j — is an :class:`Encoder` on the
    mesh's device (dp=i, tp=j) holding tp piece j of every leaf: its heads
    of attention, its columns of the FFN's ``wi``, its rows of the
    vocabulary and its classes of the head, the rest whole. An MoE model's
    ep shard k, on device (dp=i, ep=k), holds experts k·E/ep .. of every
    block. Replicas of one piece on one device are one module, so dp
    replicas that share a card share their weights (and, training, sum
    their gradients as they go).

    The forward runs every shard layer by layer: the batch rows split over
    dp, each tp shard carries the whole residual stream and attends with its
    heads (the kernel launched once per shard), a block sums over its tp
    shards after attention and after the FFN (``layers.encoder_block_tp``),
    the vocab-split embedding sums once, and the class-split logits gather
    before the loss or top-k. Routing an MoE layer is decided on shard (i,
    0)'s router before its slots go to the ep shards; routing groups that
    span dp replicas (a batch of fewer than ``MOE_GROUP_TOKENS`` tokens per
    replica) route together on replica 0, as on one device. A leaf whose
    dims do not divide its axes replicates (``shardings.sanitize_specs``)
    and its sublayer runs whole on shard 0.

    This forward is the encoder's only one: a one-device :class:`Encoder`
    runs it as the one shard of its device (:meth:`of`)."""

    def __init__(self, flat: Optional[Dict[str, np.ndarray]], cfg: EncoderConfig,
                 specs: Dict[str, tuple], mesh, trainable: bool = False,
                 modules: Optional[Dict[tuple, Encoder]] = None) -> None:
        from agent_tpu_torch.parallel.shardings import REPLICATED, slice_of, weight_split

        self.cfg, self.mesh, self.specs, self.trainable = cfg, mesh, specs, trainable
        self.shape = shape = mesh.shape
        self.dp, self.tp = shape.get("dp", 1), shape.get("tp", 1)

        def split(key: str) -> bool:
            return weight_split(specs, key, shape)

        self.embed_split, self.head_split = split("embed"), split("head")
        self.attn_split = [split(f"blocks.{l}.attn.wq") for l in range(cfg.n_layers)]
        self.ffn_split = [split(f"blocks.{l}.ffn.wi") for l in range(cfg.n_layers)]
        self.moe = cfg.moe_experts > 0
        self.n_ep = shape.get("ep", 1) if self.moe and split("blocks.0.moe.wi") else 1
        self.modules: Dict[tuple, Encoder] = {}
        if modules is not None:
            self.modules = modules
            return
        mode = quant.flat_mode(flat)
        for i in range(self.dp):
            for j in range(self.tp):
                for k in range(self.n_ep if j == 0 else 1):
                    key = self._key(i, j, k)
                    if key in self.modules:
                        continue
                    held = {n: slice_of(v, specs.get(n, REPLICATED), shape, {"tp": j, "ep": k})
                            for n, v in flat.items()
                            if (k == 0 and (j == 0 or not _is_expert(n)))
                            or (k > 0 and _is_expert(n))}
                    self.modules[key] = layers.place_pieces(meta_encoder(cfg, mode, trainable),
                                                            held, key[0])

    @classmethod
    def of(cls, model: Encoder) -> "ShardedEncoder":
        """``model`` as the one shard of a mesh of its own device."""
        from agent_tpu_torch.runtime.mesh import one_device_mesh

        mesh = one_device_mesh(model.embed.device)
        return cls(None, model.cfg, {}, mesh, model.training,
                   modules={(mesh.device_at(), 0, 0): model})

    def _key(self, i: int, j: int, k: int = 0) -> tuple:
        return (self.mesh.device_at(dp=i, tp=j, ep=k), j, k)

    def shard(self, i: int, j: int) -> Encoder:
        return self.modules[self._key(i, j)]

    def held(self, i: int, j: int, k: int = 0) -> Dict[str, torch.Tensor]:
        """The leaves the shard at (dp i, tp j, ep k) holds, by dotted key
        (its live tensors; {} where no shard is)."""
        m = self.modules.get(self._key(i, j, k))
        if m is None:
            return {}
        return {n: t for n, t in [*m.named_parameters(), *m.named_buffers()] if not t.is_meta}

    def experts(self, i: int, layer: int) -> list:
        """Block ``layer``'s MoE modules of dp replica i, one per ep shard."""
        return [self.modules[self._key(i, 0, k)].blocks[layer].moe for k in range(self.n_ep)]

    def parameters(self):
        """Every parameter a shard holds, each once."""
        seen, out = set(), []
        for m in self.modules.values():
            for p in m.parameters():
                if not p.is_meta and id(p) not in seen:
                    seen.add(id(p))
                    out.append(p)
        return out

    def train(self, mode: bool = True) -> "ShardedEncoder":
        for m in self.modules.values():
            m.train(mode)
        return self

    def eval(self) -> "ShardedEncoder":
        return self.train(False)

    def __call__(self, *args, **kwargs):
        return self.forward(*args, **kwargs)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor,
                attn_fn: AttnFn = layers.dot_product_attention,
                remat: bool = False, with_aux: bool = False):
        """The encoder's forward: embeddings and positions, the pre-LN
        blocks, the final LN, the mean over real tokens and the head;
        ``ids``/``mask`` [B, L] on any device (B divisible by dp), logits
        [B, n_classes] f32 on that device (:meth:`Encoder.forward`). On a mesh
        with dp or tp a mesh attention function (``runtime.attention_fn()``)
        gives each shard its own (``attn_fn.shard(i, j)``); any other runs
        on every shard. ``remat`` checkpoints each layer of every shard."""
        from agent_tpu_torch.parallel import collectives

        cfg = self.cfg
        leaders = [self.mesh.device_at(dp=i) for i in range(self.dp)]
        ids_s = collectives.scatter_rows(ids, leaders)
        mask_s = collectives.scatter_rows(mask, leaders)
        fn_of = getattr(attn_fn, "shard", None) if self.dp * self.tp > 1 else None
        xs, masks, fns, shards = [], [], [], []
        for i in range(self.dp):
            shards.append([self.shard(i, j) for j in range(self.tp)])
            devs = [self.mesh.device_at(dp=i, tp=j) for j in range(self.tp)]
            masks.append(collectives.broadcast(mask_s[i], devs))
            fns.append([fn_of(i, j) if fn_of else attn_fn for j in range(self.tp)])
            xs.append(self._embed(shards[i], collectives.broadcast(ids_s[i], devs)))
        attn_masks = [[layers.pad_mask_to_attn(m) for m in row] for row in masks]

        def layer(l: int, xs):
            xs = [layers.encoder_block_tp([s.blocks[l] for s in shards[i]], xs[i], attn_masks[i],
                                          fns[i], self.attn_split[l], self.ffn_split[l])
                  for i in range(self.dp)]
            return self._moe(l, xs) if self.moe else (xs, None)

        aux_total = 0.0
        for l in range(cfg.n_layers):
            if remat:
                xs, aux = checkpoint(layer, l, xs, use_reentrant=False)
            else:
                xs, aux = layer(l, xs)
            if self.moe:
                aux_total = aux_total + aux
        logits = torch.cat([self._head(shards[i], xs[i], masks[i]).to(ids.device)
                            for i in range(self.dp)])
        if with_aux:
            aux = (aux_total / max(1, cfg.n_layers)).to(ids.device) if self.moe \
                else logits.new_zeros(())
            return logits, aux
        return logits

    def _embed(self, shards, ids):
        from agent_tpu_torch.parallel import collectives

        if self.embed_split:
            rows, dtype = shards[0].embed.shape[0], self.cfg.compute_dtype
            tot = collectives.all_reduce_sum([layers.vocab_lookup(s.embed, t, j * rows, dtype)
                                              for j, (s, t) in enumerate(zip(shards, ids))])
        else:
            tot = layers.on_first(lambda: shards[0].lookup(ids[0]), ids)
        return [s.add_positions(t) for s, t in zip(shards, tot)]

    def _moe(self, layer: int, xs):
        """Block ``layer``'s MoE sublayer for every dp replica -> (the new
        residual streams, the mean aux loss)."""
        dtype = self.cfg.compute_dtype
        owners = [self.shard(i, 0).blocks[layer] for i in range(self.dp)]
        hs = [b.ln2(x[0]) for b, x in zip(owners, xs)]
        B, L, d = hs[0].shape
        flat = [h.to(dtype).reshape(B * L, d) for h in hs]
        group = min(B * L * self.dp, moe.MOE_GROUP_TOKENS)
        if (B * L) % group == 0:
            outs = [b.moe.dispatch(h, group, self.experts(i, layer))
                    for i, (b, h) in enumerate(zip(owners, flat))]
            ys = [y for y, _ in outs]
            aux = sum(a.to(flat[0].device) for _, a in outs) / self.dp
        else:  # the routing groups span the replicas: route them together
            dev = flat[0].device
            y, aux = owners[0].moe.dispatch(torch.cat([h.to(dev) for h in flat]), group,
                                           self.experts(0, layer))
            ys = [part.to(h.device) for part, h in zip(y.chunk(self.dp), flat)]
        return [[x + y.reshape(B, L, d).to(x.device).to(x.dtype) for x in row]
                for row, y in zip(xs, ys)], aux

    def _head(self, shards, xs, masks) -> torch.Tensor:
        from agent_tpu_torch.parallel import collectives

        if not self.head_split:
            return shards[0].pool_logits(xs[0], masks[0])
        return collectives.all_gather([s.pool_logits(x, m) for s, x, m in zip(shards, xs, masks)],
                                      dim=-1)[0]

    def sync_grads(self) -> None:
        """After a backward: sum each leaf's gradient over every copy of the
        same piece (a replicated leaf's tp shards, dp replicas on distinct
        devices), so every copy takes the same update."""
        from agent_tpu_torch.parallel import collectives

        groups: Dict[tuple, list] = {}
        for (_, j, k), m in self.modules.items():
            at = {"tp": j, "ep": k}
            for name, p in m.named_parameters():
                if p.is_meta:
                    continue
                piece = tuple((a, at[a]) for a in self.specs.get(name, ())
                              if a in at and self.shape.get(a, 1) > 1)
                groups.setdefault((name, piece), []).append(p)
        for ps in groups.values():
            if len(ps) > 1:
                grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in ps]
                for p, g in zip(ps, collectives.all_reduce_sum(grads)):
                    p.grad = g

    def to_flat_numpy(self) -> Dict[str, np.ndarray]:
        """The pieces gathered back into the flat layout of
        :func:`from_jax_params` (``parallel.shardings.gather_flat``)."""
        from agent_tpu_torch.parallel.shardings import gather_flat

        pieces: Dict[tuple, Dict[str, np.ndarray]] = {}

        def piece_at(coords):
            key = (coords.get("tp", 0), coords.get("ep", 0))
            if key not in pieces:
                pieces[key] = {n: layers.leaf_numpy(t) for n, t in self.held(0, *key).items()}
            return pieces[key]

        return gather_flat(piece_at, self.specs, self.shape)


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
