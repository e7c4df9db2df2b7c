"""INT8 quantized execution — counterpart of ``agent_tpu.models.quant``.

Two execution modes, the reference's, selected by ``model_config {"quant":
...}`` or ``TPU_QUANT``:

- ``int8`` (W8A8): weights symmetric per-output-channel int8, quantized once
  on the host from the f32 weights (``scale = max(amax, 1e-8) / 127``,
  ``rint``, clip ±127); activations quantized per row at run time (abs-max
  in the input dtype, then f32; round half to even, as ``jnp.round``);
  ``int8 × int8 → int32`` through ``torch._int_mm`` (cuBLASLt on the card);
  the product dequantized as ``y · (s_x · s_w)`` in f32, the bias added in
  f32, then cast to the compute dtype.
- ``w8a16`` (weight only): the same int8 tables; ``x @ w8.to(dtype)`` in the
  compute dtype, then ``· s_w`` (and the bias) in f32, then the cast.

What stays float is the reference's: embeddings, norms, attention scores
and context, routers, heads and lm heads.

Leaf convention (the reference's): a quantized matmul weight is a dict
``{"w_q": int8, "w_scale": f32}`` (``"w8"`` for w8a16), plus ``"b"`` (f32)
for a dense layer. The dict-tree families (BERT, BART, T5) hold such dicts
and dispatch on them (:func:`dense`). The module families (encoder,
seq2seq) hold :class:`QuantLeaf` modules whose buffers bear the same names,
so a state dict's keys are the reference's flattened keys
(``blocks.0.attn.wq.w_q``); :func:`quantize_` swaps them in.

The tables are made from f32 on the host (:func:`quantize_tree`), never
from the serving form's bf16 cast: quantizing a bf16-rounded weight gives
other scales and other codes than the reference's.

On the card ``torch._int_mm`` takes more than 16 rows and inner and outer
sizes that are multiples of 8, and cuBLASLt's int8 GEMM takes its weight
operand column-major (a row-major ``[K, N]`` is refused,
``CUBLAS_STATUS_NOT_SUPPORTED``, unless the rows are a multiple of 32).
So every table is stored with its contracting axes last (:func:`gemm_layout`:
the GEMM's ``[K, N]`` view is column-major), and :func:`int_mm` pads with
zeros (a zero row or column adds nothing to any product) and slices the
result. Nothing falls back to a float product.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

Params = Dict[str, Any]

QMAX = 127.0
# Floor of every scale: an all-zero row or column would divide by zero;
# 1e-8 / 127 keeps true zeros exact.
EPS = 1e-8
QUANTIZED_MODES = ("int8", "w8a16")
VALID_QUANT = ("none",) + QUANTIZED_MODES
TABLE_KEY = {"int8": "w_q", "w8a16": "w8"}  # the int8 table's leaf name per mode
# torch._int_mm's CUDA shape rules: rows > 16, inner and outer sizes % 8.
INT_MM_MIN_ROWS = 17
INT_MM_ALIGN = 8


def validate_quant(value: str) -> str:
    """A payload or env ``quant`` value, validated; ValueError otherwise."""
    if value not in VALID_QUANT:
        raise ValueError(f"quant must be one of {VALID_QUANT}, got {value!r}")
    return value


def leaf_mode(leaf: Any) -> Optional[str]:
    """``"int8"``, ``"w8a16"`` or None for a float leaf (a dict leaf)."""
    if isinstance(leaf, dict):
        if "w_q" in leaf:
            return "int8"
        if "w8" in leaf:
            return "w8a16"
    return None


# ---- weight quantization (host numpy, from f32) ----

def _storage_order(ndim: int, contract: Tuple[int, ...]) -> list:
    """The axes in the order a table is stored: the others, then ``contract``."""
    return [i for i in range(ndim) if i not in contract] + list(contract)


def gemm_layout(table: np.ndarray, contract: Tuple[int, ...]) -> np.ndarray:
    """``table``'s values stored with the ``contract`` axes last (a strided
    view of a copy), so the GEMM's ``[K, N]`` view of it is column-major."""
    order = _storage_order(table.ndim, contract)
    return np.ascontiguousarray(table.transpose(order)).transpose(np.argsort(order))


def quantize_weight(w: Any, reduce_axes: Tuple[int, ...], mode: str = "int8") -> Params:
    """Symmetric per-channel int8 with the scale over ``reduce_axes`` (the
    contracting axes) -> ``{table: int8, "w_scale": f32[kept axes]}``, the
    table in :func:`gemm_layout`."""
    w = np.asarray(w, dtype=np.float32)
    amax = np.max(np.abs(w), axis=reduce_axes, keepdims=True)
    scale = np.maximum(amax, EPS) / QMAX
    table = np.clip(np.rint(w / scale), -QMAX, QMAX).astype(np.int8)
    return {TABLE_KEY[mode]: gemm_layout(table, reduce_axes),
            "w_scale": np.squeeze(scale, axis=reduce_axes).astype(np.float32)}


def quantize_dense(p: Params, mode: str = "int8") -> Params:
    """``{"w": [in, out], "b"}`` -> ``{table, "w_scale": [out], "b"}``."""
    out = quantize_weight(p["w"], (0,), mode)
    out["b"] = np.asarray(p["b"], dtype=np.float32)
    return out


def _quantize_attn(a: Params, mode: str) -> Params:
    """wq/wk/wv ``[d, H, E]`` (scale [H, E]) and wo ``[H, E, d]`` (scale
    [d], over H and E jointly)."""
    out = {k: quantize_weight(a[k], (0,), mode) for k in ("wq", "wk", "wv")}
    out["wo"] = quantize_weight(a["wo"], (0, 1), mode)
    return out


def _quantize_block(b: Params, mode: str) -> Params:
    nb = dict(b)
    nb["attn"] = _quantize_attn(b["attn"], mode)
    if "ffn" in b:
        nb["ffn"] = {k: quantize_dense(b["ffn"][k], mode) for k in ("wi", "wo")}
    if "moe" in b:
        # Expert-stacked weights [E, in, out]: one scale per expert and
        # output channel. The router stays f32 (its argmax is fragile).
        m = b["moe"]
        nb["moe"] = {"router": m["router"], "wi": quantize_weight(m["wi"], (1,), mode),
                     "wo": quantize_weight(m["wo"], (1,), mode)}
    if "xattn" in b:
        nb["xattn"] = _quantize_attn(b["xattn"], mode)
    return nb


def quantize_encoder(params: Params, mode: str = "int8") -> Params:
    """The in-house encoder's tree: every block's QKVO, FFN or MoE experts."""
    return dict(params, blocks=[_quantize_block(b, mode) for b in params["blocks"]])


def quantize_seq2seq(params: Params, mode: str = "int8") -> Params:
    """The in-house seq2seq's tree: every encoder and decoder block, cross
    attention included; the tied lm head stays float."""
    return dict(params, enc=[_quantize_block(b, mode) for b in params["enc"]],
                dec=[_quantize_block(b, mode) for b in params["dec"]])


def quantize_bert(params: Params, mode: str = "int8") -> Params:
    """HF BERT's tree: per-layer q/k/v/o and the FFN's i/o dense dicts."""
    layers_ = []
    for blk in params["layers"]:
        a, f = blk["attn"], blk["ffn"]
        layers_.append({
            "attn": dict({k: quantize_dense(a[k], mode) for k in ("q", "k", "v", "o")},
                         ln=a["ln"]),
            "ffn": dict({k: quantize_dense(f[k], mode) for k in ("i", "o")}, ln=f["ln"]),
        })
    return dict(params, layers=layers_)


def _quantize_branches(params: Params, quantize_block) -> Params:
    out = dict(params)
    for branch in ("enc", "dec"):
        out[branch] = dict(params[branch],
                           layers=[quantize_block(b) for b in params[branch]["layers"]])
    return out


def quantize_bart(params: Params, mode: str = "int8") -> Params:
    """HF BART's tree: self and cross q/k/v/o, fc1 and fc2; the tied lm
    head and ``final_logits_bias`` stay float."""
    def block(blk: Params) -> Params:
        nb = dict(blk, self={k: quantize_dense(v, mode) for k, v in blk["self"].items()},
                  fc1=quantize_dense(blk["fc1"], mode), fc2=quantize_dense(blk["fc2"], mode))
        if "cross" in blk:
            nb["cross"] = {k: quantize_dense(v, mode) for k, v in blk["cross"].items()}
        return nb

    return _quantize_branches(params, block)


def quantize_t5(params: Params, mode: str = "int8") -> Params:
    """HF T5's tree: attention, cross attention and FFN matrices (no
    biases). The port keeps HF's ``[out, in]`` layout for ``F.linear``, so
    the scale reduces over axis 1, where the reference's ``[in, out]``
    reduces over axis 0: the same scales, and the tables transposed."""
    def block(blk: Params) -> Params:
        nb = dict(blk)
        for part in ("attn", "cross", "ffn"):
            if part in blk:
                nb[part] = {k: quantize_weight(w, (1,), mode) for k, w in blk[part].items()}
        return nb

    return _quantize_branches(params, block)


FAMILY_QUANTIZERS = {"encoder": quantize_encoder, "seq2seq": quantize_seq2seq,
                     "bert": quantize_bert, "bart": quantize_bart, "t5": quantize_t5}


def tree_mode(tree: Any) -> Optional[str]:
    """The mode of the first quantized leaf in a nested tree, or None."""
    mode = leaf_mode(tree)
    if mode is not None:
        return mode
    items = tree.values() if isinstance(tree, dict) else tree if isinstance(tree, list) else ()
    for v in items:
        mode = tree_mode(v)
        if mode is not None:
            return mode
    return None


def _to_f32(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_f32(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", torch.float32).numpy()
    return np.asarray(tree, dtype=np.float32)


def quantize_tree(tree: Params, family: str, mode: str) -> Params:
    """The float tree of ``family`` quantized to ``mode`` from its f32
    values (numpy or tensors of any float type, read to f32 on the host);
    the tree itself when ``mode`` is ``"none"`` or it is quantized already."""
    if mode not in QUANTIZED_MODES or tree_mode(tree) is not None:
        return tree
    return FAMILY_QUANTIZERS[family](_to_f32(tree), mode)


def flat_mode(flat: Dict[str, Any]) -> Optional[str]:
    """The mode of a flat dotted-key dict whose leaves are quantized, or None."""
    for key in flat:
        leaf = key.rsplit(".", 1)[-1]
        if leaf in ("w_q", "w8"):
            return "int8" if leaf == "w_q" else "w8a16"
    return None


def quantize_flat(flat: Dict[str, Any], family: str, mode: str) -> Tuple[Dict[str, Any],
                                                                         Optional[str]]:
    """A module family's flat dotted-key dict quantized to ``mode`` as
    :func:`quantize_tree` does (unless ``mode`` is ``"none"`` or it is
    quantized already) -> (the dict, the mode of its leaves or None)."""
    from agent_tpu_torch.models import layers

    if mode in QUANTIZED_MODES and flat_mode(flat) is None:
        flat = layers.flatten(quantize_tree(layers.unflatten(flat), family, mode))
    return flat, flat_mode(flat)


# ---- activation quantization (device) ----

def act_amax(x: torch.Tensor) -> torch.Tensor:
    """Each row's abs-max over the last axis, keepdim, in x's dtype."""
    return torch.maximum(x.amax(dim=-1, keepdim=True), -x.amin(dim=-1, keepdim=True))


def quantize_act(x: torch.Tensor, amax: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric int8 over the last axis -> (x_q int8, scale f32 keepdim).
    The abs-max (``amax``, else :func:`act_amax` of x) is taken in x's dtype
    (exact in any float type), then f32; one f32 copy of x is made and
    rounded in place (at BERT-base width the FFN's activation is
    gigabytes)."""
    if amax is None:
        amax = act_amax(x)
    scale = amax.float().clamp_min(EPS) / QMAX
    y = x.to(torch.float32, copy=True).div_(scale).round_().clamp_(-QMAX, QMAX)
    return y.to(torch.int8), scale


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a`` [M, K] int8 @ ``b`` [K, N] int8 -> [M, N] int32, exact, through
    ``torch._int_mm``, with the card's rules met on every device: rows up
    to ``INT_MM_MIN_ROWS`` and K and N up to multiples of 8 by zero padding
    (zeros change no product), ``b`` column-major (the tables are stored
    so; another layout is copied)."""
    m, k = a.shape
    n = b.shape[1]
    pad_m = max(0, INT_MM_MIN_ROWS - m)
    pad_k = -k % INT_MM_ALIGN
    pad_n = -n % INT_MM_ALIGN
    if pad_m or pad_k:
        a = F.pad(a, (0, pad_k, 0, pad_m))
    bt = b.t()  # [N, K], contiguous when b is column-major
    if pad_k or pad_n:
        bt = F.pad(bt, (0, pad_k, 0, pad_n))
    y = torch._int_mm(a, bt.contiguous().t())
    return y[:m, :n] if pad_m or pad_n else y


def qmatmul(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
            b: Optional[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """W8A8: x [..., K] @ w_q [K, N] (any 2-D strides) -> [..., N] in
    ``dtype``; per-row activation scales, per-column weight scales
    (``w_scale``, N values in any shape)."""
    lead, k = x.shape[:-1], x.shape[-1]
    n = w_q.shape[1]
    x_q, sx = quantize_act(x.reshape(-1, k))
    y = int_mm(x_q, w_q).float() * (sx * w_scale.reshape(1, n))
    if b is not None:
        y = y + b
    return y.to(dtype).reshape(*lead, n)


def wmatmul(x: torch.Tensor, w8: torch.Tensor, w_scale: torch.Tensor,
            b: Optional[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """W8A16: x [..., K] @ w8 [K, N] in ``dtype``, then the f32 epilogue."""
    y = torch.matmul(x.to(dtype), w8.to(dtype)).float() * w_scale.reshape(-1)
    if b is not None:
        y = y + b
    return y.to(dtype)


def _matmul(p: Params, x: torch.Tensor, w2d: torch.Tensor, dtype: torch.dtype,
            bias: bool = True) -> torch.Tensor:
    fn = qmatmul if "w_q" in p else wmatmul
    return fn(x, w2d, p["w_scale"], p.get("b") if bias else None, dtype)


def _table(p: Params) -> torch.Tensor:
    return p["w_q"] if "w_q" in p else p["w8"]


# The reference's matmuls, on dict leaves of the reference's shapes.

def dense(p: Params, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x [..., in] @ table [in, out] (+ b): ``qdense`` or ``wdense``."""
    return _matmul(p, x, _table(p), dtype)


def linear(p: Params, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """T5's bias-free layer on a table of HF's ``[out, in]`` layout."""
    return _matmul(p, x, _table(p).t(), dtype)


def proj_in(p: Params, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x [B, L, d] @ table [d, H, E] -> [B, H, L, E] (``qproj_in``/``wproj_in``)."""
    d, h, e = _table(p).shape
    y = _matmul(p, x, _table(p).reshape(d, h * e), dtype)
    return y.view(x.shape[0], x.shape[1], h, e).transpose(1, 2)


def proj_out(p: Params, o: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """o [B, H, L, E] @ table [H, E, d] -> [B, L, d], the activation scale
    over H and E jointly (``qproj_out``/``wproj_out``)."""
    h, e, d = _table(p).shape
    b, _, length, _ = o.shape
    ot = o.transpose(1, 2).reshape(b, length, h * e)
    return _matmul(p, ot, _table(p).reshape(h * e, d), dtype, bias=False)


def moe_expert(p: Params, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The expert FFN's matmul, expert-major: x [E, N, in] @ table [E, in,
    out] -> [E, N, out] (``qmoe_expert``/``wmoe_expert`` with the expert
    axis first); each capacity row quantizes over its features, each
    expert's table has its own [out] scales. W8A8 takes one ``_int_mm`` per
    expert; w8a16 one batched product."""
    t = _table(p)
    if "w_q" in p:
        return torch.stack([qmatmul(x[i], t[i], p["w_scale"][i], None, dtype)
                            for i in range(t.shape[0])])
    y = torch.bmm(x.to(dtype), t.to(dtype)).float() * p["w_scale"][:, None, :]
    return y.to(dtype)


def row_parallel(ps: List[Params], xs: List[torch.Tensor], dtype: torch.dtype,
                 bias: bool = True) -> List[torch.Tensor]:
    """A row-parallel quantized product over the tp shards: shard j holds
    ``ps[j]`` (its table as ``[K_j, N]``, the replicated ``w_scale`` [N] and
    ``b``) and the input ``xs[j]`` [..., K_j] -> the full product, one per
    shard. W8A8 quantizes each row with the abs-max over **every** shard
    (an ``all_reduce_max`` first, as GSPMD quantizes the whole activation)
    and sums the int32 partials, so the result is the one-device product
    exactly; w8a16 sums the partial products in the compute dtype. The bias
    is added once, after the sum."""
    from agent_tpu_torch.parallel import collectives

    lead = xs[0].shape[:-1]
    if "w_q" in ps[0]:
        flat = [x.reshape(-1, x.shape[-1]) for x in xs]
        amax = collectives.all_reduce_max([act_amax(x) for x in flat])
        coded = [quantize_act(x, a) for x, a in zip(flat, amax)]
        acc = collectives.all_reduce_sum([int_mm(xq, p["w_q"]) for (xq, _), p in zip(coded, ps)])
        out = []
        for (_, sx), y, p in zip(coded, acc, ps):
            y = y.float() * (sx * p["w_scale"].reshape(1, -1))
            if bias and "b" in p:
                y = y + p["b"]
            out.append(y.to(dtype).reshape(*lead, -1))
        return out
    total = collectives.all_reduce_sum([torch.matmul(x.to(dtype), p["w8"].to(dtype))
                                        for x, p in zip(xs, ps)])
    out = []
    for y, p in zip(total, ps):
        y = y.float() * p["w_scale"].reshape(-1)
        if bias and "b" in p:
            y = y + p["b"]
        out.append(y.to(dtype))
    return out


def as_2d(p: Params, k_dims: int) -> Params:
    """A quantized leaf's dict with its table viewed as ``[K, N]``, the
    first ``k_dims`` axes folded into K."""
    t = _table(p)
    k = int(np.prod(t.shape[:k_dims]))
    return dict(p, **{TABLE_KEY[leaf_mode(p)]: t.reshape(k, -1)})


# ---- the module families' leaves ----

class QuantLeaf(nn.Module):
    """A quantized matmul weight as buffers named as the reference's leaf:
    the int8 table (``w_q`` for int8, ``w8`` for w8a16) of the float
    weight's shape, its ``contract`` axes stored last, ``w_scale`` (f32)
    over the other axes, and for a dense layer ``b`` (f32). Called, it is
    the dense layer's quantized forward; attention and the experts read
    :attr:`p`."""

    def __init__(self, mode: str, shape: Tuple[int, ...], contract: Tuple[int, ...],
                 dtype: torch.dtype, bias: bool = False, device=None) -> None:
        super().__init__()
        self.mode = mode
        self.dtype = dtype
        # The table in gemm_layout: loading a state dict copies into it.
        order = _storage_order(len(shape), contract)
        table = torch.zeros([shape[i] for i in order], dtype=torch.int8, device=device)
        self.register_buffer(TABLE_KEY[mode], table.permute(*np.argsort(order).tolist()))
        scale_shape = [n for i, n in enumerate(shape) if i not in contract]
        self.register_buffer("w_scale", torch.ones(scale_shape, device=device))
        if bias:
            self.register_buffer("b", torch.zeros(shape[-1], device=device))

    @property
    def p(self) -> Dict[str, torch.Tensor]:
        return dict(self._buffers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(self.p, x, self.dtype)


def _swap(owner: nn.Module, name: str, leaf: QuantLeaf) -> None:
    delattr(owner, name)  # a parameter or a module of that name
    setattr(owner, name, leaf)


def quantize_(model: nn.Module, mode: str) -> nn.Module:
    """Swap every transformer block's float matmul weights in ``model`` for
    :class:`QuantLeaf` buffers of ``mode`` (attention's wq/wk/wv/wo, the
    cross attention's, the FFN's dense layers, the experts' wi/wo), in
    place: a state dict quantized on the host (:func:`quantize_tree`) then
    loads into it. Embeddings, norms, routers and heads stay as they are."""
    from agent_tpu_torch.models import layers, moe

    validate_quant(mode)
    for block in list(model.modules()):
        if not isinstance(block, (layers.EncoderBlock, layers.DecoderBlock)):
            continue
        for attn in (getattr(block, "attn", None), getattr(block, "xattn", None)):
            if attn is None:
                continue
            for name in ("wq", "wk", "wv", "wo"):
                w = getattr(attn, name)
                contract = (0, 1) if name == "wo" else (0,)
                _swap(attn, name, QuantLeaf(mode, tuple(w.shape), contract, attn.dtype,
                                            device=w.device))
        ffn = getattr(block, "ffn", None)
        if ffn is not None:
            for name in ("wi", "wo"):
                d = getattr(ffn, name)
                _swap(ffn, name, QuantLeaf(mode, tuple(d.w.shape), (0,), d.dtype, bias=True,
                                           device=d.w.device))
        experts = getattr(block, "moe", None)
        if isinstance(experts, moe.MoeFFN):
            for name in ("wi", "wo"):
                w = getattr(experts, name)
                _swap(experts, name, QuantLeaf(mode, tuple(w.shape), (1,), experts.dtype,
                                               device=w.device))
    return model
