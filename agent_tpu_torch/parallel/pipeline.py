"""Pipeline parallelism over the ``pp`` mesh axis: the GPipe schedule of the
encoder's blocks — counterpart of ``agent_tpu.parallel.pipeline``.

Stage s holds layers ``[s·n/pp, (s+1)·n/pp)`` on the mesh's device (dp=i,
pp=s) of each dp replica i; stage 0 also holds the embedding and the last
stage the final norm and the head (the reference runs those outside its
``shard_map``). The batch splits over dp, each replica's rows into
``n_micro`` microbatches (default ``pp``), and microbatch m enters stage 0
at tick m and reaches stage s at tick m + s: the host issues the ticks in
order, and an activation moves to the next stage's device by
``Tensor.to(device, non_blocking=True)``, so stages on distinct cards work
on different microbatches at once. The reference computes its bubble ticks
on zeros (one SPMD program); one process need not, so the port runs only
the real (stage, microbatch) pairs. Each microbatch goes through the same
blocks in the same order as the sequential forward.

MoE does not combine with pp (the reference refuses the pairing), and
training does not take pp.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from agent_tpu_torch.models import layers, quant
from agent_tpu_torch.models.layers import AttnFn


def stage_blocks(blocks: Sequence, pp: int) -> List[list]:
    """``blocks`` cut into ``pp`` stages of consecutive layers; a depth that
    does not divide raises the reference's ValueError."""
    n = len(blocks)
    if n % pp:
        raise ValueError(f"n_layers {n} not divisible by pp={pp}")
    per = n // pp
    return [list(blocks[s * per:(s + 1) * per]) for s in range(pp)]


def run_stage(stage: int, blocks: Sequence, x: torch.Tensor, mask: torch.Tensor,
              attn_fn: AttnFn) -> torch.Tensor:
    """One stage's blocks on one microbatch."""
    for block in blocks:
        x = block(x, mask, attn_fn)
    return x


def pipeline_blocks(stages: Sequence[Sequence], devices: Sequence[torch.device],
                    x: torch.Tensor, mask: torch.Tensor, attn_fn: AttnFn,
                    n_micro: Optional[int] = None) -> torch.Tensor:
    """The stacked blocks through the GPipe schedule: ``stages[s]`` on
    ``devices[s]``, x [B, L, D] and the padding mask [B, L] cut into
    ``n_micro`` microbatches (default ``len(stages)``) -> [B, L, D] on x's
    device."""
    pp = len(stages)
    n_micro = n_micro or pp
    if x.shape[0] % n_micro:
        raise ValueError(f"batch {x.shape[0]} not divisible by n_micro={n_micro}")
    xm, mm = list(x.chunk(n_micro)), list(mask.chunk(n_micro))
    for tick in range(n_micro + pp - 1):
        for s in range(pp):
            m = tick - s
            if 0 <= m < n_micro:
                dev = devices[s]
                xm[m] = run_stage(s, stages[s], xm[m].to(dev, non_blocking=True),
                                  layers.pad_mask_to_attn(mm[m].to(dev, non_blocking=True)),
                                  attn_fn)
    return torch.cat([h.to(x.device, non_blocking=True) for h in xm])


def _stage_of(key: str, n_layers: int, pp: int) -> int:
    """The stage that holds a leaf of the encoder's flat layout."""
    if key.startswith("blocks."):
        return int(key.split(".")[1]) // (n_layers // pp)
    return pp - 1 if key.startswith(("ln_f.", "head.")) else 0


class PipelinedEncoder:
    """The encoder over a ``(dp, pp)`` mesh: each dp replica's stages hold
    their layers (:func:`stage_blocks`), on their devices; weights whole
    within a stage (a tp axis of the mesh is not used by the pipeline, as
    in the reference's stage specs)."""

    def __init__(self, flat: Dict[str, np.ndarray], cfg, mesh, trainable: bool = False,
                 n_micro: Optional[int] = None) -> None:
        from agent_tpu_torch.models.encoder import meta_encoder

        self.cfg, self.mesh, self.n_micro = cfg, mesh, n_micro
        self.pp, self.dp = mesh.shape["pp"], mesh.shape.get("dp", 1)
        if cfg.moe_experts > 0:
            raise ValueError("pp and moe_experts cannot combine in one config")
        stage_blocks(range(cfg.n_layers), self.pp)  # refuses a depth that does not divide
        mode = quant.flat_mode(flat)
        self.stages: Dict[tuple, torch.nn.Module] = {}
        for i in range(self.dp):
            for s in range(self.pp):
                key = (mesh.device_at(dp=i, pp=s), s)
                if key not in self.stages:
                    held = {n: v for n, v in flat.items()
                            if _stage_of(n, cfg.n_layers, self.pp) == s}
                    self.stages[key] = layers.place_pieces(meta_encoder(cfg, mode, trainable),
                                                           held, key[0])

    def stage(self, i: int, s: int):
        return self.stages[(self.mesh.device_at(dp=i, pp=s), s)]

    def __call__(self, *args, **kwargs):
        return self.forward(*args, **kwargs)

    def forward(self, ids: torch.Tensor, mask: torch.Tensor,
                attn_fn: AttnFn = layers.dot_product_attention, remat: bool = False,
                with_aux: bool = False):
        if remat or with_aux:
            raise ValueError("the pipeline serves; it does not train")
        return encoder_forward_pp(self, ids, mask, attn_fn, self.n_micro)

    def to_flat_numpy(self) -> Dict[str, np.ndarray]:
        """Every stage's leaves, in the flat layout of ``from_jax_params``."""
        out: Dict[str, np.ndarray] = {}
        for s in range(self.pp):
            m = self.stage(0, s)
            for name, t in list(m.named_parameters()) + list(m.named_buffers()):
                if not t.is_meta:
                    out[name] = layers.leaf_numpy(t)
        return out


def encoder_forward_pp(model: PipelinedEncoder, ids: torch.Tensor, mask: torch.Tensor,
                       attn_fn: AttnFn = layers.dot_product_attention,
                       n_micro: Optional[int] = None) -> torch.Tensor:
    """The encoder's forward with the blocks pipelined over ``pp``: the
    embedding on stage 0, the final norm, pooling and head on the last
    stage, per dp replica -> logits [B, n_classes] f32 on ids' device. The
    batch must divide by ``n_micro · dp``. A mesh attention function gives
    each stage its shard's own (``attn_fn.shard(i, 0)``)."""
    from agent_tpu_torch.parallel import collectives

    cfg, pp, dp = model.cfg, model.pp, model.dp
    n_micro = n_micro or pp
    B = ids.shape[0]
    if B % (n_micro * dp):
        raise ValueError(f"batch {B} not divisible by n_micro*dp={n_micro * dp}")
    leaders = [model.mesh.device_at(dp=i) for i in range(dp)]
    fn_of = getattr(attn_fn, "shard", None)
    out = []
    for i, (ids_i, mask_i) in enumerate(zip(collectives.scatter_rows(ids, leaders),
                                            collectives.scatter_rows(mask, leaders))):
        first, last = model.stage(i, 0), model.stage(i, pp - 1)
        x = first.add_positions(first.lookup(ids_i))
        stages = stage_blocks(list(range(cfg.n_layers)), pp)
        blocks = [[model.stage(i, s).blocks[l] for l in stages[s]] for s in range(pp)]
        devices = [model.mesh.device_at(dp=i, pp=s) for s in range(pp)]
        x = pipeline_blocks(blocks, devices, x, mask_i, fn_of(i, 0) if fn_of else attn_fn,
                            n_micro)
        dev = devices[-1]
        logits = last.pool_logits(x.to(dev, non_blocking=True), mask_i.to(dev, non_blocking=True))
        out.append(logits.to(ids.device, non_blocking=True))
    return torch.cat(out)
