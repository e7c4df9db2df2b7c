"""Sharding specs of the model families over the port's mesh — the port's own
copy of ``agent_tpu.parallel.shardings``' spec trees, and the cutting of
flat weights into per-shard pieces by them.

A spec is a tuple with one entry per dim of its leaf: ``None``
(replicated) or the name of the mesh axis the dim is split over; ``()``
replicates the whole leaf. Spec trees are flat dicts keyed by the dotted
keys of the weights (``blocks.0.attn.wq``). The layouts are the reference's
(Megatron):

- attention ``wq/wk/wv`` ``[d, H, E]`` split the heads over ``tp`` (column
  parallel) and ``wo`` ``[H, E, d]`` the same heads (row parallel), so a
  block sums across shards twice, after attention's output projection and
  after the FFN's;
- the FFN's ``wi`` splits ``d_ff`` with its bias (column), ``wo`` its input
  rows (row), whose bias is replicated and added once, after the sum;
- embeddings split the vocabulary over ``tp``; layer norms and position
  tables replicate; MoE experts split over ``ep``, the router replicates.

One process owns the whole mesh: :func:`shard_flat` cuts host arrays into
the piece each mesh position holds (the shape the reference's
``NamedSharding`` puts on that device), and :func:`gather_flat` puts the
pieces back together.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

Spec = Tuple[Optional[str], ...]
Specs = Dict[str, Spec]

REPLICATED: Spec = ()
COL: Spec = (None, "tp")
ROW: Spec = ("tp", None)
HEADS_IN: Spec = (None, "tp", None)
HEADS_OUT: Spec = ("tp", None, None)
EXPERTS: Spec = ("ep", None, None)
VOCAB: Spec = ("tp", None)


def _flat(tree: Any, prefix: str = "") -> Specs:
    """A nested dict/list of specs -> the flat dotted-key dict."""
    out: Specs = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list)):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _attn() -> Dict[str, Spec]:
    return {"wq": HEADS_IN, "wk": HEADS_IN, "wv": HEADS_IN, "wo": HEADS_OUT}


def _dense(col: bool) -> Dict[str, Spec]:
    return {"w": COL, "b": ("tp",)} if col else {"w": ROW, "b": REPLICATED}


def _ln() -> Dict[str, Spec]:
    return {"scale": REPLICATED, "bias": REPLICATED}


def moe_specs() -> Dict[str, Any]:
    """The MoE FFN's subtree: experts over ``ep``, the router replicated."""
    return {"router": {"w": REPLICATED}, "wi": EXPERTS, "wo": EXPERTS}


def _block(cross: bool = False, moe: bool = False) -> Dict[str, Any]:
    p: Dict[str, Any] = {"ln1": _ln(), "attn": _attn(), "ln2": _ln()}
    if moe:
        p["moe"] = moe_specs()
    else:
        p["ffn"] = {"wi": _dense(col=True), "wo": _dense(col=False)}
    if cross:
        p["ln_x"] = _ln()
        p["xattn"] = _attn()
    return p


def encoder_specs(cfg) -> Specs:
    """Specs of ``models.encoder.init_params(cfg)`` (MoE blocks included)."""
    moe = getattr(cfg, "moe_experts", 0) > 0
    return _flat({
        "embed": VOCAB,
        "pos": REPLICATED,
        "blocks": [_block(moe=moe) for _ in range(cfg.n_layers)],
        "ln_f": _ln(),
        "head": _dense(col=True),
    })


def bert_specs(cfg) -> Specs:
    """Specs of the BERT tree: q/k/v and the intermediate layer column
    parallel, the two output projections row parallel, the word embedding
    vocab-split, the pooler column and the head row parallel."""
    blk = {
        "attn": {"q": _dense(True), "k": _dense(True), "v": _dense(True),
                 "o": _dense(False), "ln": _ln()},
        "ffn": {"i": _dense(True), "o": _dense(False), "ln": _ln()},
    }
    return _flat({
        "embed": {"word": VOCAB, "pos": REPLICATED, "type": REPLICATED, "ln": _ln()},
        "layers": [blk for _ in range(cfg.num_layers)],
        "pooler": _dense(col=True),
        "head": _dense(col=False),
    })


def seq2seq_specs(cfg) -> Specs:
    """Specs of ``models.seq2seq.init_params(cfg)``."""
    return _flat({
        "embed": VOCAB,
        "pos": REPLICATED,
        "enc": [_block() for _ in range(cfg.n_enc_layers)],
        "dec": [_block(cross=True) for _ in range(cfg.n_dec_layers)],
        "ln_enc": _ln(),
        "ln_dec": _ln(),
    })


def t5_specs(cfg) -> Specs:
    """Specs of the reference's T5 tree (bias-free ``[in, out]`` linears;
    RMSNorm scales and the relative-bias tables replicate)."""
    def attn():
        return {"q": COL, "k": COL, "v": COL, "o": ROW}

    def blk(cross: bool):
        ffn = ({"wi_0": COL, "wi_1": COL, "wo": ROW} if cfg.gated_ffn
               else {"wi": COL, "wo": ROW})
        p: Dict[str, Any] = {"attn": attn(), "ln1": REPLICATED, "ffn": ffn,
                             "ln2": REPLICATED}
        if cross:
            p["cross"] = attn()
            p["ln_x"] = REPLICATED
        return p

    def branch(n: int, cross: bool):
        return {"rel_bias": REPLICATED, "layers": [blk(cross) for _ in range(n)],
                "ln_f": REPLICATED}

    out: Dict[str, Any] = {"embed": VOCAB, "enc": branch(cfg.n_enc_layers, False),
                           "dec": branch(cfg.n_dec_layers, True)}
    if not cfg.tie_word_embeddings:
        out["lm_head"] = COL
    return _flat(out)


def bart_specs(cfg) -> Specs:
    """Specs of the BART tree: BERT's column/row pattern, the tied
    embedding vocab-split."""
    def attn():
        return {"q": _dense(True), "k": _dense(True), "v": _dense(True), "o": _dense(False)}

    def blk(cross: bool):
        p: Dict[str, Any] = {"self": attn(), "ln1": _ln(), "fc1": _dense(True),
                             "fc2": _dense(False), "ln2": _ln()}
        if cross:
            p["cross"] = attn()
            p["ln_x"] = _ln()
        return p

    def branch(n: int, cross: bool):
        return {"pos": REPLICATED, "ln_emb": _ln(), "layers": [blk(cross) for _ in range(n)]}

    return _flat({"embed": VOCAB, "final_logits_bias": REPLICATED,
                  "enc": branch(cfg.n_enc_layers, False),
                  "dec": branch(cfg.n_dec_layers, True)})


FAMILY_SPECS = {"encoder": encoder_specs, "bert": bert_specs, "seq2seq": seq2seq_specs,
                "t5": t5_specs, "bart": bart_specs}

_TABLES = ("w_q", "w8")  # models.quant's table leaf names


def t5_layout_specs(cfg) -> Specs:
    """:func:`t5_specs` in the layout the port's T5 holds: HF's ``[out,
    in]`` linears for ``F.linear`` (ROADMAP Queue 2), so a column-parallel
    linear splits dim 0 and a row-parallel one dim 1 (the reference's tree is
    ``[in, out]``). The embedding is ``[V, d]`` in both. A quantized
    linear's table takes its weight's spec and its scale, taken over the
    input dim (axis 1, ``quant.quantize_t5``), keeps dim 0's entry: those
    leaves are named here, since ``_contract`` cannot tell T5's ``cross.q``
    from BART's, whose tables contract over axis 0."""
    out: Specs = {}
    for key, spec in t5_specs(cfg).items():
        if len(spec) == 2 and key != "embed":
            spec = spec[::-1]
            out.update({f"{key}.{t}": spec for t in _TABLES})
            out[f"{key}.w_scale"] = spec[:1]
        out[key] = spec
    return out


# The specs weights are placed by, in the layout each family holds them.
LAYOUT_SPECS = dict(FAMILY_SPECS, t5=t5_layout_specs)


def _contract(key: str) -> Tuple[int, ...]:
    """The contracting axes of a quantized table (``models.quant``'s):
    attention ``wo`` over (H, E), the experts over their input dim, every
    other table over its input dim."""
    if key.endswith(".wo") and ".moe." not in key and ".ffn." not in key:
        return (0, 1)
    return (1,) if ".moe." in key else (0,)


def quantize_specs(specs: Specs, flat: Dict[str, Any]) -> Specs:
    """The specs of ``flat`` where its leaves are quantized (``models.quant``'s
    leaf convention): a table (``w_q``/``w8``) takes its float weight's spec,
    and ``w_scale`` keeps that spec's entries of the axes the scale was not
    taken over (the reference's ``quantize_specs_for_family``). A key whose
    spec is not in ``specs`` replicates."""
    out: Specs = {}
    for key in flat:
        if key in specs:
            out[key] = specs[key]
            continue
        parent, _, leaf = key.rpartition(".")
        base = parent if parent in specs else parent + ".w"
        spec = specs.get(base, REPLICATED)
        if leaf == "w_scale" and spec:
            contract = _contract(parent)
            spec = tuple(s for i, s in enumerate(spec) if i not in contract)
        out[key] = spec if leaf in ("w_q", "w8", "w_scale") else REPLICATED
    return out


def sanitize_specs(mesh_shape: Dict[str, int], flat: Dict[str, Any], specs: Specs) -> Specs:
    """The reference's per-leaf guard: an axis the mesh lacks is dropped,
    and a leaf with a dim that does not divide its axis (6 heads on tp = 4)
    replicates whole. The quantized leaves of ``flat`` take their float
    weight's spec (:func:`quantize_specs`); keys without a spec replicate."""
    specs = quantize_specs(specs, flat)
    out: Specs = {}
    for key, leaf in flat.items():
        spec = specs.get(key, REPLICATED)
        shape = np.shape(leaf)
        if len(spec) > len(shape):
            out[key] = REPLICATED
            continue
        spec = tuple(a if a in mesh_shape else None for a in spec)
        if any(a is not None and dim % mesh_shape[a] for dim, a in zip(shape, spec)):
            spec = REPLICATED
        out[key] = spec
    return out


def splits_weights(mesh_shape: Dict[str, int]) -> bool:
    """Whether weights are placed split on this mesh (the reference's
    ``get_params``): a model-parallel axis, ``tp`` or ``ep``, above 1."""
    return mesh_shape.get("tp", 1) > 1 or mesh_shape.get("ep", 1) > 1


def placement_specs(mesh_shape: Dict[str, int], flat: Dict[str, Any], specs: Specs) -> Specs:
    """The specs weights are placed by: sanitized ``specs`` when the mesh
    splits weights (:func:`splits_weights`), else every leaf replicated."""
    if splits_weights(mesh_shape):
        return sanitize_specs(mesh_shape, flat, specs)
    return {k: REPLICATED for k in flat}


def is_split(spec: Spec, mesh_shape: Dict[str, int]) -> bool:
    """Whether a (sanitized) spec splits its leaf over an axis of size > 1."""
    return any(a is not None and mesh_shape.get(a, 1) > 1 for a in spec)


def weight_split(specs: Specs, key: str, mesh_shape: Dict[str, int]) -> bool:
    """Whether the weight at ``key`` (a bare leaf, a dense layer's ``w`` or a
    quantized table under it) is split over the mesh by ``specs``."""
    spec = next((specs[k] for k in (key, key + ".w_q", key + ".w8", key + ".w")
                 if k in specs), REPLICATED)
    return is_split(spec, mesh_shape)


def slice_of(leaf: Any, spec: Spec, mesh_shape: Dict[str, int], coords: Dict[str, int]):
    """The piece of ``leaf`` the mesh position ``coords`` holds under
    ``spec`` (a view of ``leaf``)."""
    index = []
    for dim, axis in zip(np.shape(leaf), spec):
        if axis is None:
            index.append(slice(None))
            continue
        n = dim // mesh_shape[axis]
        c = coords.get(axis, 0)
        index.append(slice(c * n, (c + 1) * n))
    return leaf[tuple(index)] if index else leaf


def positions(mesh_shape: Dict[str, int]) -> List[Dict[str, int]]:
    """Every mesh position as axis -> coordinate, in the mesh's (C) order."""
    names = list(mesh_shape)
    grid = np.indices([mesh_shape[n] for n in names]).reshape(len(names), -1).T
    return [dict(zip(names, map(int, row))) for row in grid]


def shard_flat(flat: Dict[str, Any], specs: Specs,
               mesh_shape: Dict[str, int]) -> List[Dict[str, Any]]:
    """Each mesh position's piece of every leaf of ``flat`` (views), one
    dict per position in :func:`positions` order. ``specs`` should be
    sanitized against the mesh."""
    return [{k: slice_of(v, specs.get(k, REPLICATED), mesh_shape, c) for k, v in flat.items()}
            for c in positions(mesh_shape)]


def _is_tensor(x: Any) -> bool:
    return type(x).__module__.startswith("torch")


def gather_flat(piece_at: Callable[[Dict[str, int]], Dict[str, Any]], specs: Specs,
                mesh_shape: Dict[str, int]) -> Dict[str, np.ndarray]:
    """The inverse of :func:`shard_flat`: ``piece_at(coords)`` gives the
    dict a mesh position holds (``coords`` names only the axes of the
    leaf's split dims; every other axis is at 0), and each leaf of
    ``specs`` is the concatenation of its pieces along its split dims (a
    tensor of torch tensors, a numpy array of anything else)."""
    out: Dict[str, np.ndarray] = {}
    for key, spec in specs.items():
        def build(dim: int, coords: Dict[str, int]):
            if dim == len(spec):
                piece = piece_at(coords)[key]
                return piece if _is_tensor(piece) else np.asarray(piece)
            axis = spec[dim]
            if axis is None or mesh_shape.get(axis, 1) == 1:
                return build(dim + 1, coords)
            parts = [build(dim + 1, {**coords, axis: c}) for c in range(mesh_shape[axis])]
            if _is_tensor(parts[0]):
                import torch

                return torch.cat(parts, dim=dim)
            return np.concatenate(parts, axis=dim)

        out[key] = build(0, {})
    return out
