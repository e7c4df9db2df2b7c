"""On-device statistics of ``risk_accumulate`` — the port's counterpart of
``agent_tpu.parallel.collectives.mesh_reduce_stats`` for a one-device
runtime (dp = 1; a dp mesh waits for the port's dp/tp). Plain torch
reductions on the runtime's device, not a hand-written kernel.

The reference's contract is kept:

- the sum comes from a hi/lo f32 pair (hi = f32(v), lo = f32(v - hi)), the
  two device partial sums combined on the host in f64, so no input-cast
  error, only f32 accumulation error (worst case relative ``n · 2⁻²⁴``);
- min and max come from monotone integer keys of the f32 bit patterns, so
  they equal the f32 rounding of the exact extremes, subnormals included:
  nothing on the float datapath can flush them. torch's ``uint32`` support
  is thin, so the keys are built in ``int64``;
- NaN in the input gives NaN in every statistic;
- a value beyond the f32 range stays a detectable inf (its residual is set
  to 0, not ∓inf).
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np
import torch

_SIGN = 0x80000000
_ALL = 0xFFFFFFFF


def mesh_reduce_stats(runtime, values: Sequence[float]) -> Dict[str, Any]:
    """count/sum/mean/min/max of ``values``, reduced on the runtime's
    device. Returns the ``risk_accumulate`` result fields; the caller adds
    ``ok`` and the timing."""
    n = len(values)
    if n == 0:
        return {"count": 0, "sum": 0.0, "mean": 0.0, "min": None, "max": None}
    if runtime.axis_size("dp") > 1:
        raise ValueError("a dp mesh is not supported by agent_tpu_torch yet")
    v64 = np.asarray(values, dtype=np.float64)
    if np.isnan(v64).any():
        nan = float("nan")
        return {"count": n, "sum": nan, "mean": nan, "min": nan, "max": nan}
    # The overflowing cast and the inf arithmetic are the documented
    # behaviour here; silence numpy's warnings for exactly that.
    with np.errstate(over="ignore", invalid="ignore"):
        hi = v64.astype(np.float32)
        lo = np.where(np.isfinite(hi), v64 - hi.astype(np.float64), 0.0).astype(np.float32)
    hi_t, lo_t = runtime.put_batch(hi), runtime.put_batch(lo)
    sums = torch.stack([hi_t.sum(), lo_t.sum()])
    bits = hi_t.view(torch.int32).to(torch.int64) & _ALL
    keys = torch.where(bits >= _SIGN, bits ^ _ALL, bits ^ _SIGN)
    s_hi, s_lo = sums.double().tolist()
    k_mn, k_mx = torch.stack([keys.min(), keys.max()]).tolist()
    total = s_hi + s_lo
    return {"count": n, "sum": total, "mean": total / n,
            "min": _key_to_f32(k_mn), "max": _key_to_f32(k_mx)}


def _key_to_f32(key: int) -> float:
    """Invert the monotone order key back to its f32 value (host side)."""
    bits = key ^ (_SIGN if key & _SIGN else _ALL)
    return float(np.uint32(bits).view(np.float32))
