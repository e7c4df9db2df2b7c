"""Ring attention — sequence parallelism over the ``sp`` mesh axis;
counterpart of ``agent_tpu.parallel.ring``.

Every shard of the ring holds one block of query rows and, at each hop, one
block of keys and values. Shard i folds its own K/V block first; at hop h it
folds block (i - h) mod sp, which it receives from shard i - 1, into a
streaming softmax state (running row max m, denominator l, numerator acc,
all f32). After sp hops every query block has seen every K/V block, and the
output is ``acc / max(l, 1e-30)`` (a row with no real key gives 0). That is
the reference's hop order (its ``ppermute`` perm j -> j + 1), so both
packages fold, and round, in the same order.

One process owns the whole mesh, as one ``TpuRuntime`` owns it in the
reference. Shard i lives on the mesh's device i, and a K/V block moves to
the next shard by ``Tensor.to(device, non_blocking=True)``: a peer copy
between two cards, which PyTorch orders against the current streams of
both, and no copy at all when the two shards share one device (one card
running the ring, or the CPU in the tests).

On a mesh with dp or tp the ring runs in each (dp, tp) group over the
group's sp devices, with the group's batch rows and heads; a batch or head
count the mesh cannot split runs the flash kernel whole instead
(``SELECTION_COUNTS["unsharded"]``), never the plain attention.

Each hop's fold is :func:`~agent_tpu_torch.kernels.flash_attention.flash_fold`
(the CUDA fold kernel on the card, its plain version on the CPU) for the
shapes it takes, or the reference's einsum fold (``use_flash_fold=False``,
or other shapes). Key-padding masks only; shapes the ring cannot take (a
mask with a query axis, Lq or Lk not divisible by sp) go to
:func:`~agent_tpu_torch.models.layers.dot_product_attention`, as in the
reference. Forward only: training on an sp mesh uses dense attention.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch

from agent_tpu_torch.kernels import flash_attention as fa
from agent_tpu_torch.models.layers import (
    NEG_INF,
    dot_product_attention,
    is_key_padding_mask,
    materialize_key_padding_mask,
)

State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
# fold(q, k, v, mask, m, l, acc) -> (m, l, acc): one hop.
Fold = Callable[..., State]


def einsum_fold(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
                m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor) -> State:
    """The reference's einsum fold (``ring.py:94-107``): q scaled by D^-½ in
    f32 before QKᵀ, p kept in f32."""
    keep = mask > 0
    qf = q.float() * float(fa.softmax_scale(q.shape[-1]))
    scores = torch.matmul(qf, k.float().transpose(-1, -2))
    scores = torch.where(keep, scores, NEG_INF)
    m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
    # Masked entries contribute exactly 0 even in a wholly masked block.
    p = torch.exp(scores - m_new) * keep
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1, keepdim=True)
    acc = acc * corr + torch.matmul(p, v.float())
    return m_new, l, acc


def _split(x: torch.Tensor, dim: int, devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """``x`` cut into ``len(devices)`` equal blocks along ``dim``; block i
    contiguous on ``devices[i]``."""
    return [blk.to(dev).contiguous() for blk, dev in zip(x.chunk(len(devices), dim=dim),
                                                          devices)]


def ring_attention_blocks(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: torch.Tensor, devices: Sequence[torch.device],
                          fold: Fold) -> torch.Tensor:
    """The ring over ``devices``, each hop folded by ``fold``, for a
    key-padding ``mask`` [B, 1, 1, Lk] whose Lq and Lk divide by the ring's
    size. Output on q's device."""
    sp = len(devices)
    qs = _split(q, 2, devices)
    blocks = list(zip(_split(k, 2, devices), _split(v, 2, devices), _split(mask, 3, devices)))
    states = [fa.initial_state(x) for x in qs]
    for hop in range(sp):
        if hop:  # shard i takes the block shard i - 1 held
            blocks = [tuple(t.to(devices[i], non_blocking=True) for t in blocks[i - 1])
                      for i in range(sp)]
        states = [fold(qs[i], *blocks[i], *states[i]) for i in range(sp)]
    # A row with no real key has l == 0: emit 0, not NaN.
    outs = [(acc / torch.clamp_min(l, 1e-30)).to(q.dtype).to(q.device)
            for _, l, acc in states]
    return torch.cat(outs, dim=2)


def make_ring_attention(mesh, use_flash_fold: Optional[bool] = None):
    """``attn_fn`` running ring attention over ``mesh``'s ``sp`` axis; with
    ``sp == 1`` exactly :func:`dot_product_attention`, as in the reference.

    On a mesh with dp or tp as well the ring runs inside each (dp, tp)
    group, over that group's sp devices, with the group's batch rows and
    heads (the reference's ``P("dp", "tp", "sp", None)``); the function's
    ``shard(i, j)`` is group (i, j)'s own ring, for a model that runs per
    shard. A batch or head count that does not split runs
    :func:`~agent_tpu_torch.kernels.flash_attention.flash_attention` whole,
    counted under ``SELECTION_COUNTS["unsharded"]``.

    ``use_flash_fold``: None (the default) or True folds each hop with
    ``flash_fold`` for the shapes it takes (d_head 32/64/128, bf16 or f32),
    the kernel on the card; False, and every other shape, with the einsum
    fold. Each ring adds one to ``SELECTION_COUNTS["ring"]``, or to
    ``["ring_dense"]`` when its shapes go to dense attention."""
    shape = mesh.shape
    sp = shape.get("sp", 1)
    if sp <= 1:
        return dot_product_attention

    def ring_over(devices: Sequence[torch.device]):
        def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           mask: torch.Tensor) -> torch.Tensor:
            B, Lq, Lk = q.shape[0], q.shape[2], k.shape[2]
            ring_ok = is_key_padding_mask(mask, B, Lk) and Lq % sp == 0 and Lk % sp == 0
            fa.SELECTION_COUNTS["ring" if ring_ok else "ring_dense"] += 1
            if not ring_ok:
                return dot_product_attention(q, k, v, mask)
            kernel = use_flash_fold is not False and fa.flash_fold_supported(q, k)
            return ring_attention_blocks(q, k, v, materialize_key_padding_mask(mask, B, Lk),
                                         devices, fa.flash_fold if kernel else einsum_fold)

        return ring_attention

    rings = {(i, j): ring_over([mesh.device_at(dp=i, tp=j, sp=s) for s in range(sp)])
             for i in range(shape.get("dp", 1)) for j in range(shape.get("tp", 1))}
    if len(rings) == 1:
        fn = rings[0, 0]
        fn.shard = lambda i, j: fn
        return fn

    def shard(i: int, j: int):
        return rings[i, j]

    return fa.mesh_attention(shard, mesh, fa.flash_attention)
