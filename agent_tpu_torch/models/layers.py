"""Transformer building blocks in PyTorch — counterpart of
``agent_tpu.models.layers``.

Initialisation reproduces the JAX package's weights exactly: ``seed_from``
and the ``init_*`` functions build the same nested dicts of float32 numpy
arrays from the same model id, through the numpy port of ``jax.random``
(:mod:`agent_tpu_torch.models.prng`). The compute side is ``nn.Module``s
whose attribute names follow the JAX parameter tree, so a module's
``state_dict`` keys are the dotted keys of ``assign_from_npz``
(``blocks.0.attn.wq``). Numerics follow the reference: layer norm in f32
with eps 1e-6, matmuls in the compute dtype, tanh GELU, attention with
scores stored in the compute dtype and softmax statistics in f32, and a
finite ``NEG_INF`` so bf16 stays NaN-free.

Each module has two forms. Serving (``trainable=False``) stores its matmul
weights in the compute dtype, frozen. Training (``trainable=True``) stores
f32 master weights with gradients, as the reference trains, and casts them
to the compute dtype at each use (``x.astype(dtype) @ w.astype(dtype)``,
``agent_tpu/models/layers.py:51-58``). The cast of a weight already in the
compute dtype returns the weight itself, so serving copies nothing per call.
Layer norm parameters are f32 in both forms.
"""

from __future__ import annotations

import hashlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from agent_tpu_torch.models import prng, quant

Params = Dict[str, Any]
AttnFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]
KV = Tuple[torch.Tensor, torch.Tensor]           # keys, values [B, H, L, E]
Cache = Optional[Dict[str, torch.Tensor]]        # {"k", "v"} [B, H, Lmax, E]

NEG_INF = -1e9  # additive mask value; finite so bf16 stays NaN-free
# numpy's float types -> what the model computes in: float64 names run in
# float32, as the reference's arrays do without jax_enable_x64.
_FLOAT_DTYPES = {np.dtype(np.float16): torch.float16, np.dtype(np.float32): torch.float32,
                 np.dtype(np.float64): torch.float32}


def compute_dtype(name: str) -> torch.dtype:
    """A config's ``dtype`` name -> the torch dtype the model computes in.
    The names are those the reference's ``jnp.dtype`` takes for a float
    type: ``"bfloat16"`` and numpy's names of float16 (``"float16"``,
    ``"half"``, ``"f2"``), float32 (``"float32"``, ``"single"``, ``"f4"``)
    and float64 (``"float64"``, ``"double"``, ``"float"``), the last run as
    float32. A name numpy does not know (``"bf16"``, ``"fp16"``) raises
    numpy's ``TypeError``, as ``jnp.dtype`` does, and so does a type that is
    no float."""
    if name == "bfloat16":
        return torch.bfloat16
    kind = np.dtype(name)
    if kind not in _FLOAT_DTYPES:
        raise TypeError(f"dtype {name!r} ({kind}) is not a float type")
    return _FLOAT_DTYPES[kind]


def config_dtype(name: str) -> torch.dtype:
    """:func:`compute_dtype` as the model ops resolve a config's ``dtype``.
    The reference takes any name ``jnp.dtype`` knows and fails later, where
    it casts ``NEG_INF`` to the compute dtype: an integer type too narrow for
    -1e9 raises numpy's OverflowError there, which this raises first."""
    if name != "bfloat16" and np.dtype(name).kind in "iu":
        np.array(int(NEG_INF), dtype=np.dtype(name))  # OverflowError when too narrow
    return compute_dtype(name)


# ---- deterministic init (numpy, bit-identical to the JAX package) ----

def seed_from(name: str) -> np.ndarray:
    """A PRNG key fully determined by ``name`` (model id -> weights)."""
    h = hashlib.sha256(name.encode("utf-8")).digest()
    return prng.PRNGKey(int.from_bytes(h[:4], "big"))


def _dense_init(key: np.ndarray, shape: Tuple[int, ...], fan_in: int) -> np.ndarray:
    scale = np.float32(1.0 / np.sqrt(max(1, fan_in)))
    return prng.normal(key, shape) * scale


def init_dense(key: np.ndarray, d_in: int, d_out: int) -> Params:
    return {"w": _dense_init(key, (d_in, d_out), d_in),
            "b": np.zeros((d_out,), np.float32)}


def init_layer_norm(d: int) -> Params:
    return {"scale": np.ones((d,), np.float32), "bias": np.zeros((d,), np.float32)}


def init_attention(key: np.ndarray, d_model: int, n_heads: int) -> Params:
    """wq/wk/wv ``[d_model, n_heads, d_head]``, wo ``[n_heads, d_head, d_model]``."""
    d_head = d_model // n_heads
    ks = prng.split(key, 4)
    return {
        "wq": _dense_init(ks[0], (d_model, n_heads, d_head), d_model),
        "wk": _dense_init(ks[1], (d_model, n_heads, d_head), d_model),
        "wv": _dense_init(ks[2], (d_model, n_heads, d_head), d_model),
        "wo": _dense_init(ks[3], (n_heads, d_head, d_model), d_model),
    }


def init_ffn(key: np.ndarray, d_model: int, d_ff: int) -> Params:
    k1, k2 = prng.split(key)
    return {"wi": init_dense(k1, d_model, d_ff), "wo": init_dense(k2, d_ff, d_model)}


def init_block(key: np.ndarray, d_model: int, n_heads: int, d_ff: int,
               cross: bool = False) -> Params:
    """An encoder block, or with ``cross`` a decoder block (adds ``ln_x`` and
    the cross-attention ``xattn``)."""
    ks = prng.split(key, 3)
    p = {
        "ln1": init_layer_norm(d_model),
        "attn": init_attention(ks[0], d_model, n_heads),
        "ln2": init_layer_norm(d_model),
        "ffn": init_ffn(ks[1], d_model, d_ff),
    }
    if cross:
        p["ln_x"] = init_layer_norm(d_model)
        p["xattn"] = init_attention(ks[2], d_model, n_heads)
    return p


def flatten(tree: Params, prefix: str = "", leaf: Callable = np.asarray) -> Dict[str, np.ndarray]:
    """Nested dicts/lists of arrays -> ``{"blocks.0.attn.wq": array, ...}``,
    each leaf through ``leaf``."""
    out: Dict[str, np.ndarray] = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.update(flatten(v, f"{prefix}{k}.", leaf))
        else:
            out[f"{prefix}{k}"] = leaf(v)
    return out


def unflatten(flat: Dict[str, Any]) -> Params:
    """``{"layers.0.attn.q.w": x, ...}`` -> nested dicts, with a node whose
    keys are all integers as a list (the inverse of :func:`flatten`)."""
    root: Dict[str, Any] = {}
    for key, value in flat.items():
        node = root
        *parents, leaf = key.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = value

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)


_F32_KEYS = ("final_logits_bias", "rel_bias")


def place_tree(tree: Any, dtype: torch.dtype, device=None, _f32: bool = False) -> Any:
    """A nested dict/list of arrays or tensors -> the same tree of
    contiguous tensors on ``device``: the leaves under a key that starts
    with ``ln`` (layer norms) or is ``final_logits_bias`` or ``rel_bias`` in
    f32, as the reference reads them, a quantized leaf's arrays as they are
    (int8 table, f32 scale and bias), every other leaf in ``dtype`` (the
    reference's cast at use, done once)."""
    if quant.leaf_mode(tree) is not None:  # the table keeps its gemm_layout strides
        return {k: torch.as_tensor(v).to(device) for k, v in tree.items()}
    if isinstance(tree, dict):
        return {k: place_tree(v, dtype, device,
                              _f32 or k.startswith("ln") or k in _F32_KEYS)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [place_tree(v, dtype, device, _f32) for v in tree]
    return torch.as_tensor(tree).to(device=device, dtype=torch.float32 if _f32 else dtype) \
        .contiguous()


def assign_from_npz(flat: Dict[str, np.ndarray], path: str) -> Dict[str, np.ndarray]:
    """Overlay a flat ``.npz`` checkpoint (dotted keys) onto ``flat``;
    leaves absent from the file keep their initialised values."""
    with np.load(path) as ckpt:
        return {k: (np.asarray(ckpt[k]) if k in ckpt.files else v)
                for k, v in flat.items()}


def sinusoidal_positions(length: int, d_model: int) -> np.ndarray:
    """Classic fixed sinusoidal position table [length, d_model] (f32)."""
    pos = np.arange(length)[:, None].astype(np.float64)
    dim = np.arange(0, d_model, 2)[None, :].astype(np.float64)
    angle = pos / np.power(10000.0, dim / d_model)
    table = np.zeros((length, d_model), dtype=np.float32)
    table[:, 0::2] = np.sin(angle)
    table[:, 1::2] = np.cos(angle)
    return table


# ---- masks ----

def pad_mask_to_attn(mask: torch.Tensor) -> torch.Tensor:
    """[B, L] padding mask (1 = real token) -> [B, 1, 1, L] broadcastable."""
    return mask[:, None, None, :]


def is_key_padding_mask(mask: torch.Tensor, batch: int, lk: int) -> bool:
    """True iff ``mask`` is a key-padding attention mask ``[B|1, 1, 1, Lk]``."""
    return (
        mask.ndim == 4
        and mask.shape[1] == 1
        and mask.shape[2] == 1
        and mask.shape[0] in (1, batch)
        and mask.shape[3] == lk
    )


def materialize_key_padding_mask(mask: torch.Tensor, batch: int, lk: int) -> torch.Tensor:
    """Broadcast a shared ``[1, 1, 1, Lk]`` mask to ``[B, 1, 1, Lk]``: the
    sharded fast paths split the mask with the batch's rows."""
    if mask.shape[0] == 1 and batch > 1:
        return mask.expand(batch, 1, 1, lk)
    return mask


# ---- compute ----

def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """Normalise in f32 whatever the compute dtype (f32 ``scale``/``bias``),
    rounding to x's dtype once at the end. PyTorch's fused layer norm in
    f32: spelled out as the reference writes it, the f32 temporaries made
    layer norm about half the device time of a BERT-base request. (The
    CUDA op does not take a bf16 input with f32 parameters, hence the
    casts.)"""
    return F.layer_norm(x.float(), x.shape[-1:], scale, bias, eps).to(x.dtype)


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
          dtype: torch.dtype) -> torch.Tensor:
    return torch.matmul(x.to(dtype), w.to(dtype)) + b.to(dtype)


def dense_leaf(p: Params, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A dense leaf of a parameter tree: ``{"w", "b"}``, or a quantized one
    (``models.quant``'s leaf convention)."""
    if quant.leaf_mode(p) is not None:
        return quant.dense(p, x, dtype)
    return dense(x, p["w"], p["b"], dtype)


def dot_product_attention(
    q: torch.Tensor,     # [B, H, Lq, D]
    k: torch.Tensor,     # [B, H, Lk, D]
    v: torch.Tensor,     # [B, H, Lk, D]
    mask: torch.Tensor,  # [B, 1|H, Lq|1, Lk] (1 = attend)
) -> torch.Tensor:
    """Masked softmax(QKᵀ)V -> [B, H, Lq, D], the reference's dense path:
    QKᵀ accumulated in f32 and stored in the compute dtype, softmax
    statistics (exp, sum, divide) in f32. Masked scores take ``NEG_INF``
    cast to the compute dtype, as the reference's ``jnp.asarray(NEG_INF,
    q.dtype)``: in float16 that is -inf. No key at all raises the
    reference's ValueError (``jnp``'s max over an empty axis)."""
    if k.shape[-2] == 0:
        raise ValueError("zero-size array to reduction operation max which has no identity")
    d = q.shape[-1]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    scores = (scores / float(np.float32(np.sqrt(d)))).to(q.dtype)
    scores = scores.masked_fill(~(mask > 0), torch.tensor(NEG_INF).to(q.dtype))
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp((scores - m).float())
    probs = (p / p.sum(dim=-1, keepdim=True)).to(q.dtype)
    return torch.matmul(probs, v)


def make_weight(shape: Tuple[int, ...], dtype: torch.dtype, device, trainable: bool,
            init=torch.empty) -> nn.Parameter:
    """A weight of the serving form (``dtype``, frozen) or of the training
    form (f32 master copy with gradients)."""
    t = init(shape, dtype=torch.float32 if trainable else dtype, device=device)
    return nn.Parameter(t, requires_grad=trainable)


class LayerNorm(nn.Module):
    def __init__(self, d: int, device=None, trainable: bool = False) -> None:
        super().__init__()
        self.scale = make_weight((d,), torch.float32, device, trainable, torch.ones)
        self.bias = make_weight((d,), torch.float32, device, trainable, torch.zeros)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.scale, self.bias)


class Dense(nn.Module):
    """``x @ w + b`` with ``w`` [d_in, d_out], computed in ``dtype``."""

    def __init__(self, d_in: int, d_out: int, dtype: torch.dtype, device=None,
                 trainable: bool = False) -> None:
        super().__init__()
        self.dtype = dtype
        self.w = make_weight((d_in, d_out), dtype, device, trainable)
        self.b = make_weight((d_out,), dtype, device, trainable, torch.zeros)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.w, self.b, self.dtype)


class Attention(nn.Module):
    """Multi-head self-attention with the head axis kept in the weights:
    wq/wk/wv ``[d, H, E]``, wo ``[H, E, d]``."""

    def __init__(self, d_model: int, n_heads: int, dtype: torch.dtype, device=None,
                 trainable: bool = False) -> None:
        super().__init__()
        e = d_model // n_heads
        self.dtype = dtype
        self.wq = make_weight((d_model, n_heads, e), dtype, device, trainable)
        self.wk = make_weight((d_model, n_heads, e), dtype, device, trainable)
        self.wv = make_weight((d_model, n_heads, e), dtype, device, trainable)
        self.wo = make_weight((n_heads, e, d_model), dtype, device, trainable)

    @staticmethod
    def _proj_in(w, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """x [B, L, d] @ w [d, H, E] -> [B, H, L, E]."""
        if isinstance(w, quant.QuantLeaf):
            return quant.proj_in(w.p, x, dtype)
        d, h, e = w.shape
        y = torch.matmul(x.to(dtype), w.reshape(d, h * e).to(dtype))
        return y.view(x.shape[0], x.shape[1], h, e).transpose(1, 2)

    @staticmethod
    def _proj_out(w, o: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """o [B, H, L, E] @ w [H, E, d] -> [B, L, d]."""
        if isinstance(w, quant.QuantLeaf):
            return quant.proj_out(w.p, o, dtype)
        h, e, d = w.shape
        b, _, length, _ = o.shape
        return torch.matmul(o.transpose(1, 2).reshape(b, length, h * e),
                            w.reshape(h * e, d).to(dtype))

    def heads(self, x: torch.Tensor, mask: torch.Tensor, attn_fn: AttnFn) -> torch.Tensor:
        """The attention output of every head this module holds, [B, H, L, E]."""
        q = self._proj_in(self.wq, x, self.dtype)
        k = self._proj_in(self.wk, x, self.dtype)
        v = self._proj_in(self.wv, x, self.dtype)
        return attn_fn(q, k, v, mask)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, attn_fn: AttnFn) -> torch.Tensor:
        return self._proj_out(self.wo, self.heads(x, mask, attn_fn), self.dtype)

    def out_leaf(self) -> Params:
        """``wo`` as a row-parallel leaf with a ``[H·E, d]`` weight."""
        if isinstance(self.wo, quant.QuantLeaf):
            return quant.as_2d(self.wo.p, 2)
        h, e, d = self.wo.shape
        return {"w": self.wo.reshape(h * e, d)}

    def kv(self, x_kv: torch.Tensor) -> KV:
        """The keys and values of ``x_kv`` [B, Lk, d] as [B, H, Lk, E]."""
        return (self._proj_in(self.wk, x_kv, self.dtype),
                self._proj_in(self.wv, x_kv, self.dtype))

    def attend(self, x_q: torch.Tensor, mask: torch.Tensor, kv: KV,
               cache: Cache = None, cache_index=0,
               block_table: Optional[torch.Tensor] = None) -> torch.Tensor:
        """:meth:`context` through the output projection -> [B, Lq, d]."""
        return self._proj_out(self.wo, self.context(x_q, mask, kv, cache, cache_index,
                                                    block_table), self.dtype)

    def context(self, x_q: torch.Tensor, mask: torch.Tensor, kv: KV,
                cache: Cache = None, cache_index=0,
                block_table: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Attention of the queries of ``x_q`` [B, Lq, d] over ``kv`` with
        dense attention (the reference's ``attention``), every head this
        module holds -> [B, H, Lq, E]. ``mask`` [B|1, 1, Lq|1, Lk] hides what
        is not yet written. With ``cache`` the new rows ``kv`` are written
        into it IN PLACE and the queries attend over the cache:

        - ``cache_index`` an int: ``k``/``v`` [B, H, Lmax, E], written at
          that position (the scan decode's ``dynamic_update_slice``);
        - ``cache_index`` a [B] tensor: one step (Lq 1), each row written at
          its own position (the continuous engine's slots); a position past
          the cache (a row frozen at the engine's last position) writes
          nothing, as the reference's one-hot select;
        - with ``block_table`` [B, MAXB] as well: ``k``/``v`` are a paged pool
          [NB, H, BS, E] (:func:`paged_write_view`)."""
        q = self._proj_in(self.wq, x_q, self.dtype)
        k, v = kv
        if cache is not None:
            if block_table is not None:
                k, v = paged_write_view(cache, k, v, cache_index, block_table, mask.shape[-1])
            elif isinstance(cache_index, torch.Tensor):
                k, v = rows_write(cache, k, v, cache_index)
            else:
                cache["k"][:, :, cache_index:cache_index + k.shape[2]] = k
                cache["v"][:, :, cache_index:cache_index + v.shape[2]] = v
                k, v = cache["k"], cache["v"]
        return dot_product_attention(q, k, v, mask)


def rows_write(cache: Dict[str, torch.Tensor], k: torch.Tensor, v: torch.Tensor,
               pos: torch.Tensor) -> KV:
    """Write one step's keys and values ``k``/``v`` [B, H, 1, E] into the
    dense ``cache`` [B, H, Lmax, E] in place, row b at ``pos[b]`` -> the
    cache's keys and values. A row whose position is past the cache keeps
    its content (the reference drops that write)."""
    lmax = cache["k"].shape[2]
    rows = torch.arange(k.shape[0], device=k.device)
    pos = pos.long()
    col = pos.clamp(max=lmax - 1)
    past = (pos >= lmax)[:, None, None]
    for name, new in (("k", k), ("v", v)):
        c = cache[name]
        # c[rows, :, col] is [B, H, E]: the indexed dimensions go first.
        c[rows, :, col] = torch.where(past, c[rows, :, col], new[:, :, 0])
    return cache["k"], cache["v"]


def paged_write_view(cache: Dict[str, torch.Tensor], k: torch.Tensor, v: torch.Tensor,
                     pos: torch.Tensor, table: torch.Tensor, lk: int) -> KV:
    """The paged KV pool (reference ``layers.attention``'s ``block_table``
    branch): ``cache["k"]``/``["v"]`` are pools [NB, H, BS, E] shared by
    every row, and row b's position p lives in pool block ``table[b, p //
    BS]`` at offset ``p % BS``. Writes one step's ``k``/``v`` [B, H, 1, E]
    in place at ``pos`` [B] and returns each row's dense-shape view [B, H,
    lk, E] (the row's blocks gathered, sliced to the mask's ``lk``), so the
    attention's shapes are the dense layout's. Pool block 0 is the trash
    block: unallocated and released entries point there, and a position past
    the table's coverage writes there too, so a frozen row can never write
    into a block handed to a live row. Positions that are not yet written
    hold stale values; the mask hides them, and ``exp(NEG_INF - m)`` in f32
    is exactly 0."""
    bsz, maxb = table.shape
    bs = cache["k"].shape[2]
    pos = pos.long()
    ji = pos // bs
    blk = torch.where(ji < maxb, table.gather(1, ji.clamp(max=maxb - 1)[:, None])[:, 0],
                      torch.zeros_like(ji))
    off = pos % bs
    views = []
    for name, new in (("k", k), ("v", v)):
        pool = cache[name]
        # Duplicate (blk, off) pairs only occur at the trash block.
        pool[blk, :, off] = new[:, :, 0]
        x = pool[table]                                   # [B, MAXB, H, BS, E]
        x = x.permute(0, 2, 1, 3, 4).reshape(bsz, pool.shape[1], maxb * bs, pool.shape[3])
        views.append(x[:, :, :lk].contiguous())
    return views[0], views[1]


class FFN(nn.Module):
    def __init__(self, d_model: int, d_ff: int, dtype: torch.dtype, device=None,
                 trainable: bool = False) -> None:
        super().__init__()
        self.wi = Dense(d_model, d_ff, dtype, device, trainable)
        self.wo = Dense(d_ff, d_model, dtype, device, trainable)

    def hidden(self, x: torch.Tensor) -> torch.Tensor:
        # jax.nn.gelu's default is the tanh form.
        return F.gelu(self.wi(x), approximate="tanh")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.wo(self.hidden(x))

    def out_leaf(self) -> Params:
        """``wo`` as a row-parallel leaf: ``{"w", "b"}`` or its quantized dict."""
        if isinstance(self.wo, quant.QuantLeaf):
            return self.wo.p
        return {"w": self.wo.w, "b": self.wo.b}


class EncoderBlock(nn.Module):
    """Pre-LN transformer block: x + Attn(LN(x)); x + FFN(LN(x)). With a
    ``moe_cfg`` (``models.moe.MoeConfig``) the FFN sublayer is the Switch
    MoE layer ``moe`` instead of ``ffn``."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int, dtype: torch.dtype,
                 device=None, trainable: bool = False, moe_cfg=None) -> None:
        super().__init__()
        self.ln1 = LayerNorm(d_model, device, trainable)
        self.attn = Attention(d_model, n_heads, dtype, device, trainable)
        self.ln2 = LayerNorm(d_model, device, trainable)
        if moe_cfg is None:
            self.ffn = FFN(d_model, d_ff, dtype, device, trainable)
        else:
            from agent_tpu_torch.models.moe import MoeFFN

            self.moe = MoeFFN(moe_cfg, device, trainable)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, attn_fn: AttnFn) -> torch.Tensor:
        """:func:`encoder_block_tp` with this block as its one shard. An MoE
        block's experts run in the encoder (``ShardedEncoder``), which routes
        across its replicas."""
        if hasattr(self, "moe"):
            raise ValueError("an MoE block runs inside its encoder")
        return encoder_block_tp([self], [x], [mask], [attn_fn], False, False)[0]


def leaf_numpy(t: torch.Tensor) -> np.ndarray:
    """A weight read back to the host: floats as f32, int8 tables as int8."""
    return (t.detach().float() if t.is_floating_point() else t.detach()).cpu().numpy()


def dense_copy(arr: Any) -> Any:
    """A compact copy of a (sliced) host numpy piece in its own dim order,
    so a quantized table keeps its ``gemm_layout``; a tensor as it is
    (placement copies it)."""
    if not isinstance(arr, np.ndarray):
        return arr
    order = np.argsort([-st for st in arr.strides], kind="stable")
    return np.ascontiguousarray(arr.transpose(order)).transpose(np.argsort(order))


def place_pieces(model: nn.Module, pieces: Dict[str, Any], device) -> nn.Module:
    """Give ``model``, built on the ``meta`` device, the leaves ``pieces``
    (dotted key -> host array) on ``device``: each takes its meta tensor's
    dtype, dim order (a quantized table keeps its ``gemm_layout``) and
    gradient flag, at the piece's shape. A shard of a model holds its
    pieces this way; the leaves it does not hold stay on ``meta``."""
    for name, arr in pieces.items():
        owner_name, _, leaf = name.rpartition(".")
        owner = model.get_submodule(owner_name) if owner_name else model
        old = owner._parameters.get(leaf)
        if old is None:
            old = owner._buffers[leaf]
        order = sorted(range(old.dim()), key=lambda d: -old.stride(d))
        shape = np.shape(arr)
        t = torch.empty([shape[d] for d in order], dtype=old.dtype, device=device)
        t = t.permute(*np.argsort(order).tolist())
        t.copy_(torch.from_numpy(np.asarray(arr)))
        if leaf in owner._parameters:
            owner._parameters[leaf] = nn.Parameter(t, requires_grad=old.requires_grad)
        else:
            owner._buffers[leaf] = t
    return model


# ---- tensor parallelism: one block's tp shards in one process ----
#
# Shard j of a block holds heads j·H/tp .. (j+1)·H/tp of q/k/v and the same
# rows of wo, and columns j·F/tp .. of the FFN's wi (with its bias) and the
# same rows of its wo. The residual stream is replicated: every shard holds
# the whole [B, L, d] activation, and the functions below take and return
# one tensor per shard. A block sums across its shards twice (after
# attention's and after the FFN's output projection), in shard order
# (parallel.collectives).

def add_bias(y: torch.Tensor, b: Optional[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    return y if b is None else y + b.to(dtype)


def row_parallel(leaves: Sequence[Params], xs: Sequence[torch.Tensor],
                 dtype: torch.dtype) -> List[torch.Tensor]:
    """Σ_j xs[j] @ leaves[j]["w"] over the shards, then the replicated
    bias once: the full product on every shard. A quantized leaf (its table
    viewed ``[K_j, N]``) goes through :func:`quant.row_parallel`."""
    if quant.leaf_mode(leaves[0]) is not None:
        return quant.row_parallel(list(leaves), list(xs), dtype)
    from agent_tpu_torch.parallel import collectives

    totals = collectives.all_reduce_sum([torch.matmul(x.to(dtype), p["w"].to(dtype))
                                         for p, x in zip(leaves, xs)])
    return [add_bias(t, p.get("b"), dtype) for t, p in zip(totals, leaves)]


def on_first(fn: Callable[[], torch.Tensor], like: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """A replicated sublayer (dims that do not divide tp): computed once on
    the first shard, its result on every shard's device."""
    from agent_tpu_torch.parallel import collectives

    return collectives.broadcast(fn(), [x.device for x in like])


def attention_tp(attns: Sequence[Attention], hs: Sequence[torch.Tensor],
                 masks: Sequence[torch.Tensor], attn_fns: Sequence[AttnFn],
                 split: bool) -> List[torch.Tensor]:
    """Self-attention over the shards: each attends with its heads on its
    device, and the row-parallel output projection sums. With ``split``
    False (heads replicated) the first shard computes it whole, its kernel
    unsharded (``SELECTION_COUNTS["unsharded"]``)."""
    if not split:
        if len(attns) > 1:
            from agent_tpu_torch.kernels.flash_attention import SELECTION_COUNTS

            SELECTION_COUNTS["unsharded"] += 1
        return on_first(lambda: attns[0](hs[0], masks[0], attn_fns[0]), hs)
    outs = [a.heads(h, m, f) for a, h, m, f in zip(attns, hs, masks, attn_fns)]
    b, _, length, _ = outs[0].shape
    flat = [o.transpose(1, 2).reshape(b, length, -1) for o in outs]
    return row_parallel([a.out_leaf() for a in attns], flat, attns[0].dtype)


def ffn_tp(ffns: Sequence[FFN], hs: Sequence[torch.Tensor], split: bool) -> List[torch.Tensor]:
    """The FFN over the shards: column-parallel ``wi``, row-parallel ``wo``
    (its bias added once); with ``split`` False the first shard's whole."""
    if not split:
        return on_first(lambda: ffns[0](hs[0]), hs)
    return row_parallel([f.out_leaf() for f in ffns], [f.hidden(h) for f, h in zip(ffns, hs)],
                        ffns[0].wo.dtype)


def encoder_block_tp(blocks: Sequence["EncoderBlock"], xs: Sequence[torch.Tensor],
                     masks: Sequence[torch.Tensor], attn_fns: Sequence[AttnFn],
                     attn_split: bool, ffn_split: bool) -> List[torch.Tensor]:
    """:meth:`EncoderBlock.forward` over its tp shards, one residual stream
    per shard. An MoE block returns after attention (the caller runs the
    experts)."""
    a = attention_tp([b.attn for b in blocks], [b.ln1(x) for b, x in zip(blocks, xs)],
                     masks, attn_fns, attn_split)
    xs = [x + y for x, y in zip(xs, a)]
    if hasattr(blocks[0], "moe"):
        return xs
    f = ffn_tp([b.ffn for b in blocks], [b.ln2(x) for b, x in zip(blocks, xs)], ffn_split)
    return [x + y for x, y in zip(xs, f)]


def vocab_lookup(table: torch.Tensor, ids: torch.Tensor, first: int,
                 dtype: torch.dtype) -> torch.Tensor:
    """Rows of a vocab-split embedding: ``table`` holds ids ``first ..
    first + len(table)``; an id outside that range reads a zero row, so the
    sum over the shards is the whole lookup (exact: x + 0 = x). The zero row
    is ``F.embedding``'s padding index, which its backward skips: pointed at
    one real row instead, the ids of every other shard (most of a batch)
    made the gradient's scatter-add serialise on it."""
    rows = table.shape[0]
    local = ids.long() - first
    local = torch.where((local >= 0) & (local < rows), local, rows)
    padded = torch.cat([table.to(dtype), table.new_zeros((1, table.shape[1]), dtype=dtype)])
    return F.embedding(local, padded, padding_idx=rows)


class DecoderBlock(nn.Module):
    """Pre-LN decoder block (the reference's ``decoder_block``): x +
    SelfAttn(LN(x)) over the KV cache; x + CrossAttn(LN(x), encoder output);
    x + FFN(LN(x)). Both attentions are dense, as the reference's."""

    def __init__(self, d_model: int, n_heads: int, d_ff: int, dtype: torch.dtype,
                 device=None) -> None:
        super().__init__()
        self.ln1 = LayerNorm(d_model, device)
        self.attn = Attention(d_model, n_heads, dtype, device)
        self.ln2 = LayerNorm(d_model, device)
        self.ffn = FFN(d_model, d_ff, dtype, device)
        self.ln_x = LayerNorm(d_model, device)
        self.xattn = Attention(d_model, n_heads, dtype, device)

    def forward(self, x: torch.Tensor, self_mask: torch.Tensor, enc_kv: KV,
                enc_mask: torch.Tensor, cache: Cache = None, cache_index=0,
                block_table: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``x`` [B, Lq, d]; ``enc_kv`` = ``self.xattn.kv(enc_out)``, which
        is the same every decode step, so callers compute it once.
        ``cache_index`` and ``block_table`` as :meth:`Attention.attend`.
        :func:`decoder_block_tp` with this block as its one shard."""
        return decoder_block_tp([self], [x], [self_mask], [enc_kv], [enc_mask], [cache],
                                [cache_index], [block_table], False, False)[0]


def attend_tp(attns: Sequence[Attention], hs: Sequence[torch.Tensor],
              masks: Sequence[torch.Tensor], kvs: Optional[Sequence[KV]], split: bool,
              caches: Optional[Sequence[Cache]] = None, index: Optional[Sequence] = None,
              tables: Optional[Sequence[Optional[torch.Tensor]]] = None) -> List[torch.Tensor]:
    """A decoder's attention over the shards (:meth:`Attention.context`):
    each shard's queries of ``hs[j]`` attend over ``kvs[j]``, its heads'
    keys and values (None: the self-attention's new rows, projected from
    ``hs``), written first into its own cache ``caches[j]`` at ``index[j]``
    (through ``tables[j]`` for a paged pool) when given; the row-parallel
    output projection sums. With ``split`` False (heads replicated) the
    first shard computes it whole, counted under
    ``SELECTION_COUNTS["unsharded"]`` when there are other shards."""
    n = len(attns)
    caches = caches or [None] * n
    index = index or [0] * n
    tables = tables or [None] * n

    def kv(j: int) -> KV:
        return attns[j].kv(hs[j]) if kvs is None else kvs[j]

    if not split:
        if n > 1:
            from agent_tpu_torch.kernels.flash_attention import SELECTION_COUNTS

            SELECTION_COUNTS["unsharded"] += 1
        return on_first(lambda: attns[0].attend(hs[0], masks[0], kv(0), caches[0], index[0],
                                                tables[0]), hs)
    outs = [a.context(h, m, kv(j), caches[j], index[j], tables[j])
            for j, (a, h, m) in enumerate(zip(attns, hs, masks))]
    b, _, length, _ = outs[0].shape
    flat = [o.transpose(1, 2).reshape(b, length, -1) for o in outs]
    return row_parallel([a.out_leaf() for a in attns], flat, attns[0].dtype)


def decoder_block_tp(blocks: Sequence[DecoderBlock], xs: Sequence[torch.Tensor],
                     self_masks: Sequence[torch.Tensor], enc_kvs: Sequence[KV],
                     enc_masks: Sequence[torch.Tensor], caches: Sequence[Cache],
                     index: Sequence, tables: Sequence[Optional[torch.Tensor]],
                     attn_split: bool, ffn_split: bool) -> List[torch.Tensor]:
    """:meth:`DecoderBlock.forward` over its tp shards, one residual stream
    per shard: each shard's self-attention writes its heads' keys and
    values into its own cache (dense rows, or a paged pool under its copy of
    the one block table) and attends over it, its cross-attention attends
    with its heads over ``enc_kvs[j]``, and each sums through the
    row-parallel ``wo``; the FFN is :func:`ffn_tp`."""
    hs = [b.ln1(x) for b, x in zip(blocks, xs)]
    a = attend_tp([b.attn for b in blocks], hs, self_masks, None, attn_split, caches, index,
                  tables)
    xs = [x + y for x, y in zip(xs, a)]
    hs = [b.ln_x(x) for b, x in zip(blocks, xs)]
    a = attend_tp([b.xattn for b in blocks], hs, enc_masks, enc_kvs, attn_split)
    xs = [x + y for x, y in zip(xs, a)]
    f = ffn_tp([b.ffn for b in blocks], [b.ln2(x) for b, x in zip(blocks, xs)], ffn_split)
    return [x + y for x, y in zip(xs, f)]


def embed_tp(tables: Sequence[torch.Tensor], ids: Sequence[torch.Tensor], split: bool,
             dtype: torch.dtype) -> List[torch.Tensor]:
    """Token embeddings on every shard: a vocab-split table's lookups
    (:func:`vocab_lookup`) summed over the shards, or the whole table's rows
    on the first shard."""
    from agent_tpu_torch.parallel import collectives

    if split:
        rows = tables[0].shape[0]
        return collectives.all_reduce_sum([vocab_lookup(t, i, j * rows, dtype)
                                           for j, (t, i) in enumerate(zip(tables, ids))])
    return on_first(lambda: tables[0][ids[0].long()].to(dtype), ids)


def vocab_logits_tp(project: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                    tables: Sequence[torch.Tensor], xs: Sequence[torch.Tensor],
                    split: bool) -> torch.Tensor:
    """The vocab-split output projection: each shard's logits of its rows of
    the vocabulary, ``project(tables[j], xs[j])``, concatenated along the
    vocabulary (not summed) on the first shard's device; a table that is
    not split projects whole there."""
    from agent_tpu_torch.parallel import collectives

    if not split:
        return project(tables[0], xs[0])
    return collectives.gather([project(t, x) for t, x in zip(tables, xs)], dim=-1)
