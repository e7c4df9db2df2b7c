"""The decoder families (the in-house seq2seq, T5, BART) over a mesh's ``dp``
and ``tp`` axes in one process — the port's counterpart of the reference's
GSPMD serving of ``seq2seq_param_specs``, ``t5_param_specs`` and
``bart_param_specs`` weights.

Shard (i, j) — dp replica i, tp shard j — lives on the mesh's device (dp=i,
tp=j) and holds tp piece j of every leaf (``parallel.shardings.LAYOUT_SPECS``):
its heads of every attention, its columns of the FFN's first matrices and
rows of its last, its rows of the vocabulary; norms, positions and T5's
relative bias tables whole. dp replicas on one device share one piece. A
leaf whose dims do not divide replicates (``shardings.sanitize_specs``), and
so does every attention leaf when the heads do not divide tp, whatever the
flattened dims allow; such a sublayer runs whole on the first shard.

A family's subclass supplies the computation of one tp group (one dp
replica's shards, one residual stream each): the encoder, the per-request
decoder state (cross-attention keys and values of its heads), its KV caches
and one decoder step, whose logits come back on the group's first device.
This class supplies what is the same for every family: the rows over dp,
the encode, and the decode loop. The loop is one loop on the mesh's first
device (``decoding.greedy_scan``/``beam_scan``): tokens, done flags and beam
scores live there; a step sends each replica its rows (each with all K beams
of its requests, so a beam reorder never crosses replicas) and gathers their
logits; the caches are ``{"replicas": [[shard cache tree, ...], ...]}``,
which ``decoding._reorder_all`` reorders with each replica's rows of the
beam indices, copied to each shard's device. A batch whose rows do not
divide dp runs on replica 0's tp group, counted under
``SELECTION_COUNTS["unsharded"]`` (the reference's ``_put`` rule).

One device is the mesh of one shard (:meth:`ShardedDecoder.of`): the
families' one-device functions run through the same group code.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch

# Key fragments of the attention leaves of every family's flat weights.
_ATTN_PARTS = (".attn.", ".xattn.", ".self.", ".cross.")


class ShardedDecoder:
    """A decoder family's shards over a mesh (see the module docstring).
    ``split`` says which parts are split over tp: ``"embed"`` (the
    vocabulary), ``"attn"`` (the heads), ``"ffn"``, and T5's untied
    ``"lm_head"``; a part that is not runs whole on the first shard."""

    # Per family: the part name -> the flat key whose spec decides it.
    SPLIT_KEYS: Dict[str, str] = {}

    def __init__(self, cfg, mesh, shards: Dict[tuple, Any], split: Dict[str, bool]) -> None:
        self.cfg, self.mesh, self.shards, self.split = cfg, mesh, shards, split
        self.dp, self.tp = mesh.shape.get("dp", 1), mesh.shape.get("tp", 1)

    # ---- placement ----

    @classmethod
    def of(cls, cfg, shard, device) -> "ShardedDecoder":
        """One device's weights ``shard`` as the one shard of its mesh."""
        from agent_tpu_torch.runtime.mesh import one_device_mesh

        mesh = one_device_mesh(torch.device(device))
        return cls(cfg, mesh, {(mesh.device_at(), 0): shard}, {})

    @classmethod
    def place(cls, flat: Dict[str, Any], cfg, specs: Dict[str, tuple], mesh) -> "ShardedDecoder":
        """The family over ``mesh`` from host ``flat`` (quantized already for
        a quantized model) and its sanitized placement ``specs``."""
        from agent_tpu_torch.parallel.shardings import REPLICATED, slice_of, weight_split

        shape = mesh.shape
        dp, tp = shape.get("dp", 1), shape.get("tp", 1)
        if cfg.n_heads % tp:
            specs = {k: (REPLICATED if any(p in k for p in _ATTN_PARTS) else s)
                     for k, s in specs.items()}
        split = {part: weight_split(specs, key, shape) for part, key in cls.SPLIT_KEYS.items()}
        shards: Dict[tuple, Any] = {}
        for i in range(dp):
            for j in range(tp):
                key = (mesh.device_at(dp=i, tp=j), j)
                if key not in shards:
                    held = {n: slice_of(v, specs.get(n, REPLICATED), shape, {"tp": j})
                            for n, v in flat.items()}
                    shards[key] = cls.build_shard(held, cfg, key[0])
        return cls(cfg, mesh, shards, split)

    @classmethod
    def build_shard(cls, held: Dict[str, Any], cfg, device) -> Any:
        """One shard's weights on ``device`` from its host pieces: a tree
        (T5's, BART's), each quantized table in its ``gemm_layout``."""
        from agent_tpu_torch.models import layers

        return layers.place_tree(layers.unflatten({k: layers.dense_copy(v)
                                                   for k, v in held.items()}),
                                 cfg.compute_dtype, device)

    # ---- the mesh ----

    def group(self, i: int) -> List[Any]:
        """dp replica i's tp shards, in tp order."""
        return [self.shards[(self.mesh.device_at(dp=i, tp=j), j)] for j in range(self.tp)]

    def devices(self, i: int) -> List[torch.device]:
        return [self.mesh.device_at(dp=i, tp=j) for j in range(self.tp)]

    def split_over(self, part: str, n: int) -> bool:
        """Whether ``part`` runs split over a group of ``n`` shards (one
        shard runs every part whole)."""
        return n > 1 and self.split.get(part, False)

    def heads(self, j: int) -> Tuple[int, int]:
        """The first head shard j holds and how many (all of them on every
        shard when the heads are not split)."""
        if not self.split.get("attn"):
            return 0, self.cfg.n_heads
        h = self.cfg.n_heads // self.tp
        return j * h, h

    def replicas(self, batch: int) -> int:
        """How many dp replicas a batch of ``batch`` rows runs on: every one
        when the rows divide dp, else replica 0 alone, counted under
        ``SELECTION_COUNTS["unsharded"]``."""
        if batch % self.dp == 0:
            return self.dp
        from agent_tpu_torch.kernels.flash_attention import SELECTION_COUNTS

        SELECTION_COUNTS["unsharded"] += 1
        return 1

    def parts(self, t: torch.Tensor, n: int) -> List[List[torch.Tensor]]:
        """``t``'s rows cut into ``n`` equal blocks, block i on every device
        of replica i's tp group."""
        from agent_tpu_torch.parallel import collectives

        return [collectives.broadcast(blk, self.devices(i))
                for i, blk in enumerate(t.chunk(n) if n > 1 else [t])]

    # ---- the family's tp group ----

    def encode_group(self, group: List[Any], ids: List[torch.Tensor],
                     masks: List[torch.Tensor], fns: List[Any]) -> List[torch.Tensor]:
        """The encoder over one tp group -> its output on every shard."""
        raise NotImplementedError

    def state_group(self, group: List[Any], encs: List[torch.Tensor],
                    masks: List[torch.Tensor], steps: int) -> List[Any]:
        """Each shard's decoder state of a decode of ``steps`` steps (its
        heads' cross-attention keys and values, its masks and biases)."""
        raise NotImplementedError

    def caches_group(self, rows: int, steps: int, devices: List[torch.device]) -> List[Any]:
        """Each shard's empty self-attention caches (its heads)."""
        raise NotImplementedError

    def step_group(self, group: List[Any], toks: List[torch.Tensor], step,
                   caches: List[Any], states: List[Any]) -> torch.Tensor:
        """One decoder step of one tp group -> logits [R, V] f32 on the
        group's first device; the caches are written in place."""
        raise NotImplementedError

    def scan_ids(self) -> Dict[str, Any]:
        """The decode loop's token ids (start, EOS, pad, forced)."""
        raise NotImplementedError

    # ---- the mesh's forward ----

    def encode_parts(self, ids: torch.Tensor, mask: torch.Tensor, attn_fn
                     ) -> Tuple[List[List[torch.Tensor]], List[List[torch.Tensor]]]:
        """The encoder over the mesh: ``ids``/``mask`` [B, L] -> (the output
        of every shard of each replica, the mask's rows there). On a mesh an
        attention function that has shards (``runtime.attention_fn()``,
        ``runtime.t5_attention_kernel()``) gives each its own
        (``attn_fn.shard(i, j)``); any other runs on every shard."""
        n = self.replicas(ids.shape[0])
        fn_of = getattr(attn_fn, "shard", None) if self.dp * self.tp > 1 else None
        id_parts, mask_parts = self.parts(ids, n), self.parts(mask, n)
        encs = [self.encode_group(self.group(i), id_parts[i], mask_parts[i],
                                  [fn_of(i, j) if fn_of else attn_fn for j in range(self.tp)])
                for i in range(n)]
        return encs, mask_parts

    def encode(self, ids: torch.Tensor, mask: torch.Tensor, attn_fn) -> torch.Tensor:
        """The encoder output [B, L, d] on ``ids``' device."""
        encs, _ = self.encode_parts(ids, mask, attn_fn)
        return torch.cat([e[0].to(ids.device, non_blocking=True) for e in encs])

    def encoded_parts(self, enc: torch.Tensor, mask: torch.Tensor):
        """An encoder output computed elsewhere (``summarize_decode``'s
        handoff), cast to the compute dtype, in :meth:`encode_parts`' form."""
        n = self.replicas(enc.shape[0])
        return self.parts(enc.to(self.cfg.compute_dtype), n), self.parts(mask, n)

    def _states(self, encs, masks, steps: int, beams: int):
        """Each replica's decoder states and empty caches for a decode of
        ``steps`` steps with ``beams`` beams (each row repeated), and the rows
        a replica decodes."""
        if beams > 1:
            encs = [[e.repeat_interleave(beams, dim=0) for e in row] for row in encs]
            masks = [[m.repeat_interleave(beams, dim=0) for m in row] for row in masks]
        states = [self.state_group(self.group(i), encs[i], masks[i], steps)
                  for i in range(len(encs))]
        rows = encs[0][0].shape[0]
        caches = {"replicas": [self.caches_group(rows, steps, self.devices(i))
                               for i in range(len(encs))]}
        return states, caches, rows

    def _step_fn(self, states):
        """The decode loop's step over the replicas in use."""
        from agent_tpu_torch.parallel import collectives

        n = len(states)

        def step_fn(tok: torch.Tensor, step, caches):
            logits = [self.step_group(self.group(i), collectives.broadcast(t, self.devices(i)),
                                      step, caches["replicas"][i], states[i])
                      for i, t in enumerate(tok.chunk(n) if n > 1 else [tok])]
            return collectives.gather(logits, dim=0).to(tok.device, non_blocking=True), caches

        return step_fn

    def decode(self, encs, masks, max_new: int, num_beams: int = 1,
               length_penalty: float = 1.0, early_stopping: bool = False,
               min_length: int = 0, cache_reorder: str = "delta"
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Greedy (or beam) decode of :meth:`encode_parts`' output -> (tokens
        [B, max_new], lengths [B]) on the mesh's first device."""
        from agent_tpu_torch.models.decoding import beam_scan, greedy_scan

        K = max(1, num_beams)
        states, caches, rows = self._states(encs, masks, max_new, K)
        B = len(encs) * rows // K
        step_fn = self._step_fn(states)
        leader = encs[0][0].device
        ids = self.scan_ids()
        if K == 1:
            return greedy_scan(step_fn, caches, B, max_new, min_length=min_length,
                               device=leader, **ids)
        return beam_scan(step_fn, caches, B, self.cfg.vocab_size, max_new, num_beams=K,
                         length_penalty=length_penalty, early_stopping=early_stopping,
                         min_length=min_length, cache_reorder=cache_reorder, device=leader,
                         **ids)

    def generate(self, ids: torch.Tensor, mask: torch.Tensor, max_new: int, attn_fn,
                 **kw) -> Tuple[torch.Tensor, torch.Tensor]:
        """:meth:`encode_parts` then :meth:`decode` (``kw`` its options)."""
        encs, masks = self.encode_parts(ids, mask, attn_fn)
        return self.decode(encs, masks, max_new, **kw)

    def forced_logp(self, ids: torch.Tensor, mask: torch.Tensor, tgt: torch.Tensor,
                    attn_fn) -> torch.Tensor:
        """Teacher-forced log-probabilities [B, T, V] (f32, on ``ids``'
        device) of the decoder inputs ``tgt`` [B, T], through the cached
        decoder steps the decode loop runs."""
        encs, masks = self.encode_parts(ids, mask, attn_fn)
        states, caches, _ = self._states(encs, masks, tgt.shape[1], 1)
        step_fn = self._step_fn(states)
        out = []
        for step in range(tgt.shape[1]):
            logits, caches = step_fn(tgt[:, step].to(torch.int32), step, caches)
            out.append(torch.log_softmax(logits.float(), dim=-1))
        return torch.stack(out, dim=1).to(ids.device)


def as_mesh(model, cls, cfg) -> ShardedDecoder:
    """``model`` itself when it is placed over a mesh, else one device's
    weights (a module or a tree) as the one shard of ``cls``."""
    if isinstance(model, ShardedDecoder):
        return model
    device = (next(model.parameters()).device if isinstance(model, torch.nn.Module)
              else leaf_device(model))
    return cls.of(cfg, model, device)


def leaf_device(tree: Any) -> torch.device:
    """The device of a nested dict/list's first tensor."""
    while not isinstance(tree, torch.Tensor):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else tree[0]
    return tree.device


def row_out(split: bool, inputs: Callable[[int], torch.Tensor],
            whole: Callable[[torch.Tensor], torch.Tensor], leaves: Callable[[], List[Any]],
            like: List[torch.Tensor], dtype: torch.dtype, attention: bool) -> List[torch.Tensor]:
    """A sublayer's output projection over the tp shards of ``like`` (one
    tensor a shard): with ``split`` the row-parallel sum of shard j's
    ``inputs(j)`` through ``leaves()[j]`` (``layers.row_parallel``, the bias
    once); else ``whole(inputs(0))`` on the first shard, on every shard's
    device, an ``attention`` with other shards counted under
    ``SELECTION_COUNTS["unsharded"]``."""
    from agent_tpu_torch.models import layers

    if split:
        return layers.row_parallel(leaves(), [inputs(j) for j in range(len(like))], dtype)
    if attention and len(like) > 1:
        from agent_tpu_torch.kernels.flash_attention import SELECTION_COUNTS

        SELECTION_COUNTS["unsharded"] += 1
    return layers.on_first(lambda: whole(inputs(0)), like)
