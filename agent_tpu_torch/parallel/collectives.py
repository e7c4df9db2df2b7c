"""Cross-shard collectives of the one-process mesh, and the on-device
statistics of ``risk_accumulate`` — counterpart of
``agent_tpu.parallel.collectives``.

One process owns every shard of the mesh, so a collective is a few tensor
ops in a fixed shard order: :func:`all_reduce_sum`, :func:`all_reduce_max`
and :func:`all_gather` take one tensor per shard of an axis group (each on
its shard's device) and return one result per shard, computed once on the
first shard's device and copied to each other device by
``Tensor.to(device, non_blocking=True)``; shards that share a device share
the result, with no copy. They are plain torch ops, so autograd goes
through them: the gradient of a sum reaches every shard's part.

:func:`mesh_reduce_stats` is ``risk_accumulate``'s device path. Each dp
shard reduces its slice of the values; the partials combine on the host
(sums in f64, integer keys by min/max), in dp order. On a mesh over
several processes each process reduces the slices of the positions it
holds, one gloo all-gather of the small f64 partials gives every process
every slice's, and each combines them in the same order: the result is
the same on every process, and equal to one process's over the same dp.
The reference's contract is kept:

- the sum comes from a hi/lo f32 pair (hi = f32(v), lo = f32(v - hi)), the
  device partial sums combined on the host in f64, so no input-cast error,
  only f32 accumulation error (worst case relative ``n · 2⁻²⁴``);
- min and max come from monotone integer keys of the f32 bit patterns, so
  they equal the f32 rounding of the exact extremes, subnormals included:
  nothing on the float datapath can flush them. torch's ``uint32`` support
  is thin, so the keys are built in ``int64``;
- NaN in the input gives NaN in every statistic;
- a value beyond the f32 range stays a detectable inf (its residual is set
  to 0, not ∓inf);
- the length pads to a power-of-two multiple of dp, the pad masked out.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np
import torch

_SIGN = 0x80000000
_ALL = 0xFFFFFFFF


def all_reduce_sum(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Σ parts, summed in shard order on the first part's device, one
    result per shard."""
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(total.device, non_blocking=True)
    return broadcast(total, [p.device for p in parts])


def all_reduce_max(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The elementwise maximum of ``parts``, one result per shard."""
    total = parts[0]
    for p in parts[1:]:
        total = torch.maximum(total, p.to(total.device, non_blocking=True))
    return broadcast(total, [p.device for p in parts])


def all_gather(parts: Sequence[torch.Tensor], dim: int) -> List[torch.Tensor]:
    """``parts`` concatenated along ``dim`` in shard order, one result per
    shard."""
    return broadcast(gather(parts, dim), [p.device for p in parts])


def gather(parts: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
    """``parts`` concatenated along ``dim`` in shard order, on the first
    part's device only (the leader's copy of :func:`all_gather`)."""
    dev = parts[0].device
    return torch.cat([p.to(dev, non_blocking=True) for p in parts], dim=dim)


def broadcast(t: torch.Tensor, devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """``t`` on each of ``devices`` (``Tensor.to`` returns ``t`` itself where
    it already is: no copy)."""
    return [t.to(d, non_blocking=True) for d in devices]


def scatter_rows(t: torch.Tensor, devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """``t``'s rows cut into ``len(devices)`` equal blocks, block i on
    ``devices[i]`` (the batch over dp)."""
    if t.shape[0] % len(devices):
        raise ValueError(f"batch {t.shape[0]} does not divide over dp={len(devices)}")
    return [blk.to(d, non_blocking=True) for blk, d in zip(t.chunk(len(devices)), devices)]


def padded_len(n: int, multiple: int) -> int:
    """Smallest power-of-two multiple of ``multiple`` that is >= n."""
    size = max(multiple, 1)
    while size < n:
        size *= 2
    return size


def mesh_reduce_stats(runtime, values: Sequence[float]) -> Dict[str, Any]:
    """count/sum/mean/min/max of ``values``, each dp shard reducing its
    slice on its device. Returns the ``risk_accumulate`` result fields; the
    caller adds ``ok`` and the timing."""
    n = len(values)
    if n == 0:
        return {"count": 0, "sum": 0.0, "mean": 0.0, "min": None, "max": None}
    v64 = np.zeros(padded_len(n, runtime.axis_size("dp")), dtype=np.float64)
    v64[:n] = np.asarray(values, dtype=np.float64)
    if np.isnan(v64).any():
        nan = float("nan")
        return {"count": n, "sum": nan, "mean": nan, "min": nan, "max": nan}
    # The overflowing cast and the inf arithmetic are the documented
    # behaviour here; silence numpy's warnings for exactly that.
    with np.errstate(over="ignore", invalid="ignore"):
        hi = v64.astype(np.float32)
        lo = np.where(np.isfinite(hi), v64 - hi.astype(np.float64), 0.0).astype(np.float32)
    real = np.zeros(v64.size, dtype=np.bool_)
    real[:n] = True
    mesh, dp = runtime.mesh, runtime.axis_size("dp")
    # Row i: dp slice i's (s_hi, s_lo, key_min, key_max), exact in f64 (the
    # keys are below 2^33), computed by the process holding slice i.
    rows = torch.zeros(dp, 4, dtype=torch.float64)
    for i, parts in enumerate(zip(*(np.split(x, dp) for x in (hi, lo, real)))):
        if mesh.is_local(dp=i):
            rows[i] = _slice_stats(*(torch.from_numpy(p).to(mesh.device_at(dp=i))
                                     for p in parts))
    if mesh.spans_processes:
        from agent_tpu_torch.runtime.distributed import all_gather_tensor

        every = all_gather_tensor(rows)
        rows = torch.stack([every[mesh.owner_at(dp=i)][i] for i in range(dp)])
    s_hi = s_lo = 0.0
    k_mn, k_mx = _ALL + 1, -1
    for h, l, mn, mx in rows.tolist():  # in dp order, as every process sums them
        s_hi, s_lo = s_hi + h, s_lo + l
        k_mn, k_mx = min(k_mn, int(mn)), max(k_mx, int(mx))
    total = s_hi + s_lo
    return {"count": n, "sum": total, "mean": total / n,
            "min": _key_to_f32(k_mn), "max": _key_to_f32(k_mx)}


def _slice_stats(h: torch.Tensor, l: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """One dp slice's (s_hi, s_lo, key_min, key_max) in f64, on the host."""
    sums = torch.stack([torch.where(m, h, 0.0).sum(), torch.where(m, l, 0.0).sum()])
    bits = h.view(torch.int32).to(torch.int64) & _ALL
    keys = torch.where(bits >= _SIGN, bits ^ _ALL, bits ^ _SIGN)
    # Pad sentinels: above every key for the min, below every key for the max.
    ends = torch.stack([torch.where(m, keys, _ALL + 1).min(), torch.where(m, keys, -1).max()])
    return torch.cat([sums.double(), ends.double()]).cpu()


def _key_to_f32(key: int) -> float:
    """Invert the monotone order key back to its f32 value (host side)."""
    bits = key ^ (_SIGN if key & _SIGN else _ALL)
    return float(np.uint32(bits).view(np.float32))
