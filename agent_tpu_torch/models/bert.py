"""HF-BERT-compatible encoder classifier in PyTorch — counterpart of
``agent_tpu.models.bert``: a user points ``model_path`` at a local Hugging
Face BERT checkpoint directory (``config.json`` + ``model.safetensors`` or
``pytorch_model.bin`` + ``vocab.txt``) and ``map_classify_tpu`` serves it.

BERT is not the in-house pre-LN encoder: post-LN residuals with LayerNorm
eps ``layer_norm_eps`` (1e-12), learned position embeddings plus token-type
row 0, erf-exact GELU, a tanh pooler over [CLS] and a linear head. Layer
norms, GELU and the pooler's tanh run in f32 whatever the compute dtype.
Attention goes through the ``attn_fn`` it is given, so
``runtime.attention_fn()`` puts the flash kernel in every layer, or ring
attention over ``sp``.

Weights are a nested dict named as the reference's tree
(:func:`from_state_dict` from an HF state dict, :func:`from_jax_params` from
the reference's flattened tree), dense weights ``[in, out]`` as the
reference holds them, on one device: matmul weights, biases and embeddings
in the compute dtype (the reference's cast at use, done once), layer norm
parameters in f32. No network access: checkpoints load from local disk.

Over a mesh the weights are a :class:`ShardedBert`: one tree per (dp, tp)
shard, split by ``parallel.shardings.bert_specs``. The forward is one code
path for both (:func:`forward_shards`): each tp shard attends with its
heads and computes its columns of the intermediate layer and the pooler,
and the row-parallel output projections and head sum over the shards,
their biases added once.
"""

from __future__ import annotations

import json
import os
import threading
import unicodedata
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from agent_tpu_torch.models import layers, quant
from agent_tpu_torch.models.layers import AttnFn, Params


@dataclass(frozen=True)
class BertConfig:
    """Mirror of the HF ``config.json`` fields the forward needs (the
    reference's fields and defaults)."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position: int = 512
    type_vocab: int = 2
    layer_norm_eps: float = 1e-12
    num_labels: int = 1000
    dtype: str = "bfloat16"
    # "int8" (W8A8) or "w8a16" (weight only): every layer's q/k/v/o and FFN
    # matmuls (models.quant); embeddings, norms, pooler and head stay float.
    quant: str = "none"

    # The uniform serving-config view the classify op reads off any family.
    @property
    def max_len(self) -> int:
        return self.max_position

    @property
    def n_classes(self) -> int:
        return self.num_labels

    @property
    def compute_dtype(self) -> torch.dtype:
        return layers.compute_dtype(self.dtype)

    @classmethod
    def from_hf_json(cls, path: str, **overrides) -> "BertConfig":
        try:
            with open(path) as f:
                hf = json.load(f)
        except json.JSONDecodeError as exc:
            # Not a ValueError to callers (JSONDecodeError is one, and the
            # op would soft-drop the shard as bad input): a corrupt
            # checkpoint is a retryable integrity failure.
            raise RuntimeError(f"unreadable checkpoint config.json at {path}: {exc}") from exc
        if hf.get("model_type") not in (None, "bert"):
            raise RuntimeError(
                f"not a BERT checkpoint (model_type={hf.get('model_type')!r}"
                " — map_classify_tpu serves model_type=bert; map_summarize "
                "serves BART)"
            )
        fields = dict(
            vocab_size=hf["vocab_size"],
            hidden_size=hf["hidden_size"],
            num_layers=hf["num_hidden_layers"],
            num_heads=hf["num_attention_heads"],
            intermediate_size=hf["intermediate_size"],
            max_position=hf["max_position_embeddings"],
            type_vocab=hf.get("type_vocab_size", 2),
            layer_norm_eps=hf.get("layer_norm_eps", 1e-12),
        )
        if "num_labels" in hf:
            fields["num_labels"] = hf["num_labels"]
        elif hf.get("id2label"):
            fields["num_labels"] = len(hf["id2label"])
        fields.update(overrides)
        return cls(**fields)


def _ln(p: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    return layers.layer_norm(x, p["scale"], p["bias"], eps)


_dense = layers.dense_leaf


def forward(params, ids: torch.Tensor, mask: torch.Tensor, cfg: BertConfig,
            attn_fn: AttnFn = layers.dot_product_attention) -> torch.Tensor:
    """ids, mask [B, L] int (mask 1 = real token) -> sequence-classification
    logits [B, num_labels] f32: embeddings (word + learned position + token
    type 0) -> post-LN stack -> tanh pooler over [CLS] -> head. ``params``
    is one device's tree or a :class:`ShardedBert`."""
    if isinstance(params, ShardedBert):
        return params.forward(ids, mask, attn_fn)
    return forward_shards([params], [ids], [mask], cfg, [attn_fn])


def forward_shards(trees: List[Params], ids: List[torch.Tensor], masks: List[torch.Tensor],
                   cfg: BertConfig, attn_fns: List[AttnFn],
                   split: Optional[Dict[str, bool]] = None) -> torch.Tensor:
    """:func:`forward` over the tp shards of one dp replica: ``trees[j]``,
    ``ids[j]``, ``masks[j]`` and ``attn_fns[j]`` on shard j's device ->
    the logits on shard 0's. ``split`` says which parts are split over the
    shards (``"embed"``, ``"attn"``, ``"ffn"``, ``"pooler"``); a part that
    is not runs whole on shard 0. One shard is the one-device forward."""
    from agent_tpu_torch.parallel import collectives

    split = split or {}
    dtype, eps = cfg.compute_dtype, cfg.layer_norm_eps
    B, L = ids[0].shape
    d_head = cfg.hidden_size // cfg.num_heads
    one = len(trees) == 1
    emb = [t["embed"] for t in trees]
    if one or split.get("embed"):
        rows = emb[0]["word"].shape[0]
        words = collectives.all_reduce_sum(
            [layers.vocab_lookup(e["word"], i, j * rows, dtype) if not one
             else e["word"][i.long()] for j, (e, i) in enumerate(zip(emb, ids))])
    else:
        words = layers.on_first(lambda: emb[0]["word"][ids[0].long()], ids)
    xs = [_ln(e["ln"], w + e["pos"][:L][None] + e["type"][0][None, None], eps)
          for e, w in zip(emb, words)]
    attn_masks = [layers.pad_mask_to_attn(m) for m in masks]

    def heads(t: torch.Tensor) -> torch.Tensor:
        return t.view(B, L, -1, d_head).transpose(1, 2)

    def context(a: Params, x: torch.Tensor, m: torch.Tensor, f: AttnFn) -> torch.Tensor:
        c = f(heads(_dense(a["q"], x, dtype)), heads(_dense(a["k"], x, dtype)),
              heads(_dense(a["v"], x, dtype)), m)
        return c.transpose(1, 2).reshape(B, L, -1)

    def intermediate(f: Params, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(_dense(f["i"], x, dtype).float(), approximate="none").to(dtype)

    for blks in zip(*[t["layers"] for t in trees]):
        a = [b["attn"] for b in blks]
        if one or split.get("attn"):
            o = layers.row_parallel([p["o"] for p in a],
                                    [context(p, x, m, f)
                                     for p, x, m, f in zip(a, xs, attn_masks, attn_fns)], dtype)
        else:
            from agent_tpu_torch.kernels.flash_attention import SELECTION_COUNTS

            SELECTION_COUNTS["unsharded"] += 1
            o = layers.on_first(lambda: _dense(a[0]["o"], context(a[0], xs[0], attn_masks[0],
                                                                   attn_fns[0]), dtype), xs)
        xs = [_ln(p["ln"], x + y, eps) for p, x, y in zip(a, xs, o)]
        f = [b["ffn"] for b in blks]
        if one or split.get("ffn"):
            o = layers.row_parallel([p["o"] for p in f],
                                    [intermediate(p, x) for p, x in zip(f, xs)], dtype)
        else:
            o = layers.on_first(lambda: _dense(f[0]["o"], intermediate(f[0], xs[0]), dtype), xs)
        xs = [_ln(p["ln"], x + y, eps) for p, x, y in zip(f, xs, o)]
    if one or split.get("pooler"):
        pooled = [torch.tanh(_dense(t["pooler"], x[:, 0], dtype).float()).to(dtype)
                  for t, x in zip(trees, xs)]
        return layers.row_parallel([t["head"] for t in trees], pooled, dtype)[0].float()
    pooled = torch.tanh(_dense(trees[0]["pooler"], xs[0][:, 0], dtype).float()).to(dtype)
    return _dense(trees[0]["head"], pooled, dtype).float()


class ShardedBert:
    """BERT's weights over a mesh's ``dp`` and ``tp`` axes: shard (i, j) is
    the tree of tp piece j on the mesh's device (dp=i, tp=j) (dp replicas
    on one device share it). ``bert_specs`` splits q/k/v, the intermediate
    layer and the pooler by columns (their biases too), the two output
    projections and the head by rows (their biases replicated, added once),
    and the word embedding by vocabulary rows; a leaf whose dims do not
    divide replicates, and its part runs whole on shard 0."""

    def __init__(self, flat: Dict[str, np.ndarray], cfg: BertConfig, specs: Dict[str, tuple],
                 mesh) -> None:
        from agent_tpu_torch.parallel.shardings import REPLICATED, slice_of, weight_split

        self.cfg, self.mesh, self.specs = cfg, mesh, specs
        self.shape = shape = mesh.shape
        self.dp, self.tp = shape.get("dp", 1), shape.get("tp", 1)
        self.split = {part: weight_split(specs, key, shape) for part, key in (
            ("embed", "embed.word"), ("attn", "layers.0.attn.q"), ("ffn", "layers.0.ffn.i"),
            ("pooler", "pooler"))}
        self.trees: Dict[tuple, Params] = {}
        for i in range(self.dp):
            for j in range(self.tp):
                key = self._key(i, j)
                if key not in self.trees:
                    held = {n: layers.dense_copy(slice_of(v, specs.get(n, REPLICATED), shape,
                                                    {"tp": j}))
                            for n, v in flat.items()}
                    self.trees[key] = layers.place_tree(layers.unflatten(held),
                                                        cfg.compute_dtype, key[0])

    def _key(self, i: int, j: int) -> tuple:
        return (self.mesh.device_at(dp=i, tp=j), j)

    def held(self, i: int, j: int, k: int = 0) -> Dict[str, torch.Tensor]:
        """The leaves shard (dp i, tp j) holds, by dotted key (its live
        tensors; {} for an ep coordinate, which BERT does not split)."""
        tree = self.trees.get(self._key(i, j)) if k == 0 else None
        return {} if tree is None else layers.flatten(tree, leaf=lambda t: t)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor, attn_fn: AttnFn) -> torch.Tensor:
        """``forward`` over the mesh: the rows split over dp, each replica
        through :func:`forward_shards`; logits on ids' device."""
        from agent_tpu_torch.parallel import collectives

        leaders = [self.mesh.device_at(dp=i) for i in range(self.dp)]
        fn_of = getattr(attn_fn, "shard", None)
        out = []
        for i, (ids_i, mask_i) in enumerate(zip(collectives.scatter_rows(ids, leaders),
                                                collectives.scatter_rows(mask, leaders))):
            devs = [self.mesh.device_at(dp=i, tp=j) for j in range(self.tp)]
            logits = forward_shards(
                [self.trees[self._key(i, j)] for j in range(self.tp)],
                collectives.broadcast(ids_i, devs), collectives.broadcast(mask_i, devs),
                self.cfg, [fn_of(i, j) if fn_of else attn_fn for j in range(self.tp)],
                self.split)
            out.append(logits.to(ids.device, non_blocking=True))
        return torch.cat(out)


# ---- weight import ----

def _dense_from(sd: Dict[str, torch.Tensor], prefix: str) -> Params:
    """HF ``nn.Linear`` ([out, in] weight) -> ``{"w": [in, out], "b"}``."""
    return {"w": sd[f"{prefix}.weight"].t(), "b": sd[f"{prefix}.bias"]}


def _ln_from(sd: Dict[str, torch.Tensor], prefix: str) -> Params:
    return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}


def from_state_dict(sd: Dict[str, Any], cfg: BertConfig, head_seed: str = "bert-head",
                    device=None) -> Params:
    """HF BERT state dict (``BertModel`` or ``BertForSequenceClassification``
    naming, the ``bert.`` prefix stripped; numpy arrays or tensors) -> the
    port's tree on ``device``. The checkpoint's classifier is used only when
    its rows equal ``cfg.num_labels``; otherwise the head is the seeded one
    of ``head_seed``, equal to the reference's (same id, same weights).
    A quantized ``cfg.quant`` quantizes the tree's f32 values on the host."""
    return layers.place_tree(host_tree(sd, cfg, head_seed), cfg.compute_dtype, device)


def host_tree(sd: Dict[str, Any], cfg: BertConfig, head_seed: str = "bert-head") -> Params:
    """:func:`from_state_dict`'s tree on the host (quantized for a
    quantized ``cfg.quant``), before placement."""
    sd = {(k[5:] if k.startswith("bert.") else k): torch.as_tensor(v) for k, v in sd.items()}
    tree: Params = {
        "embed": {
            "word": sd["embeddings.word_embeddings.weight"],
            "pos": sd["embeddings.position_embeddings.weight"],
            "type": sd["embeddings.token_type_embeddings.weight"],
            "ln": _ln_from(sd, "embeddings.LayerNorm"),
        },
        "layers": [],
        "pooler": _dense_from(sd, "pooler.dense"),
    }
    for i in range(cfg.num_layers):
        p = f"encoder.layer.{i}"
        tree["layers"].append({
            "attn": {
                "q": _dense_from(sd, f"{p}.attention.self.query"),
                "k": _dense_from(sd, f"{p}.attention.self.key"),
                "v": _dense_from(sd, f"{p}.attention.self.value"),
                "o": _dense_from(sd, f"{p}.attention.output.dense"),
                "ln": _ln_from(sd, f"{p}.attention.output.LayerNorm"),
            },
            "ffn": {
                "i": _dense_from(sd, f"{p}.intermediate.dense"),
                "o": _dense_from(sd, f"{p}.output.dense"),
                "ln": _ln_from(sd, f"{p}.output.LayerNorm"),
            },
        })
    # A payload's num_labels override that differs from the trained head's
    # gets a fresh seeded head: a k-clamp from the override with a head of
    # another size would break top-k.
    cls_w = sd.get("classifier.weight")
    if cls_w is not None and cls_w.shape[0] == cfg.num_labels:
        tree["head"] = _dense_from(sd, "classifier")
    else:
        tree["head"] = layers.init_dense(layers.seed_from(head_seed), cfg.hidden_size,
                                         cfg.num_labels)
    return quant.quantize_tree(tree, "bert", cfg.quant)


def from_jax_params(flat: Dict[str, np.ndarray], cfg: BertConfig, device=None) -> Params:
    """The port's tree from the reference's BERT parameter tree flattened to
    dotted keys (``layers.flatten`` of ``agent_tpu.models.bert`` params:
    ``embed.word``, ``layers.0.attn.q.w``, ``head.b``, ...; quantized leaves
    ``layers.0.attn.q.w_q`` too), quantized on the host for a quantized
    ``cfg.quant``."""
    tree = quant.quantize_tree(layers.unflatten(flat), "bert", cfg.quant)
    return layers.place_tree(tree, cfg.compute_dtype, device)


def is_hf_dir(path: str) -> bool:
    """A local HF checkpoint directory: has ``config.json``."""
    return os.path.isdir(path) and os.path.exists(os.path.join(path, "config.json"))


def load_hf_dir(path: str, device=None, **config_overrides) -> Tuple[BertConfig, Params]:
    """(config, params on ``device``) from a local HF BERT checkpoint
    directory: ``model.safetensors`` (the port's own reader), else
    ``pytorch_model.bin``."""
    from agent_tpu_torch.models.safetensors_io import load_hf_weights

    cfg = BertConfig.from_hf_json(os.path.join(path, "config.json"), **config_overrides)
    return cfg, from_state_dict(load_hf_weights(path), cfg, head_seed=path, device=device)


def load_hf_flat(path: str, **config_overrides) -> Tuple[BertConfig, Dict[str, np.ndarray]]:
    """(config, the host tree of :func:`load_hf_dir` as flat dotted-key
    arrays, floats in f32): what a mesh places (:class:`ShardedBert`)."""
    from agent_tpu_torch.models.safetensors_io import load_hf_weights

    cfg = BertConfig.from_hf_json(os.path.join(path, "config.json"), **config_overrides)
    tree = host_tree(load_hf_weights(path), cfg, head_seed=path)
    return cfg, layers.flatten(tree, leaf=lambda v: layers.leaf_numpy(v)
                               if isinstance(v, torch.Tensor) else np.asarray(v))


# ---- tokenizer ----

_tok_cache: Dict[str, Any] = {}
_tok_lock = threading.Lock()


def hf_wordpiece(path: str):
    """The checkpoint's wordpiece tokenizer (``vocab.txt``), with [UNK]
    resolved from the vocab itself (it sits at whatever line the file puts
    it), lowercasing per ``tokenizer_config.json``. Cached per directory."""
    with _tok_lock:
        tok = _tok_cache.get(path)
        if tok is not None:
            return tok
    from agent_tpu_torch.models.tokenizer import WordPieceTokenizer

    vocab_path = os.path.join(path, "vocab.txt")
    if not os.path.exists(vocab_path):
        raise ValueError(f"HF checkpoint {path} has no vocab.txt")
    lowercase = True
    tcfg_path = os.path.join(path, "tokenizer_config.json")
    if os.path.exists(tcfg_path):
        with open(tcfg_path) as f:
            lowercase = bool(json.load(f).get("do_lower_case", True))
    tok = WordPieceTokenizer.from_file(vocab_path, lowercase=lowercase)
    # The class-level unk_id (3) is the in-house vocab's; an OOV word must
    # encode as the checkpoint's own [UNK] line.
    if "[UNK]" in tok.vocab:
        tok.unk_id = tok.vocab["[UNK]"]
    with _tok_lock:
        _tok_cache[path] = tok
    return tok


def _is_cjk(cp: int) -> bool:
    """HF BasicTokenizer's CJK ranges (each character becomes its own word)."""
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


def basic_normalize(text: str, strip_accents: bool) -> str:
    """HF ``BasicTokenizer`` normalisation: accents stripped (NFD, combining
    marks dropped; on with lowercasing) and CJK characters spaced out so each
    is one word."""
    if strip_accents:
        text = "".join(c for c in unicodedata.normalize("NFD", text)
                       if unicodedata.category(c) != "Mn")
    if any(_is_cjk(ord(c)) for c in text):
        text = "".join(f" {c} " if _is_cjk(ord(c)) else c for c in text)
    return text


def encode_pad_batch(tok, texts, max_len: int, batch_buckets,
                     length_buckets) -> Tuple[np.ndarray, np.ndarray]:
    """``[CLS] pieces [SEP]`` per row -> (ids [B, L] int32, lengths [B]
    int32) with bucketed shapes; bucket truncation keeps the trailing
    ``[SEP]`` (transformers' truncation)."""
    from agent_tpu_torch.models.tokenizer import bucket_length

    cls_id = tok.vocab.get("[CLS]")
    sep_id = tok.vocab.get("[SEP]")
    pad_id = tok.vocab.get("[PAD]", 0)
    if cls_id is None or sep_id is None:
        raise ValueError("vocab.txt lacks [CLS]/[SEP] tokens")
    rows = [[cls_id] + tok.encode(basic_normalize(t, tok.lowercase))[: max_len - 2] + [sep_id]
            for t in texts]
    L = bucket_length(min(max(len(r) for r in rows), max_len), length_buckets)
    B = bucket_length(len(rows), batch_buckets)
    ids = np.full((B, L), pad_id, dtype=np.int32)
    lengths = np.zeros(B, dtype=np.int32)
    for r, row in enumerate(rows):
        if len(row) > L:
            row = row[: L - 1] + [sep_id]
        ids[r, : len(row)] = row
        lengths[r] = len(row)
    return ids, lengths
