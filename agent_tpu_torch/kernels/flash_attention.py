"""Flash attention: the hand-written Hopper kernels, their plain versions,
and the selection between them and dense attention.

Counterpart of ``agent_tpu.kernels.flash_attention`` (``flash_attention``,
``flash_attention_trainable``, ``selects_flash``, ``SELECTION_COUNTS``,
``make_flash_attention``, ``make_flash_attention_trainable``, ``flash_fold``,
``flash_fold_supported``, ``flash_attention_t5``,
``make_flash_attention_t5``). The kernels are ``csrc/flash_attention.cu``
(the forwards' entry points, replacing the Pallas kernels ``_flash_kernel``,
the ring hop ``_flash_fold_kernel``, ``_flash_fwd_lse_kernel`` and
``_flash_t5_kernel``: in bf16 all four are variants of the TMA + wgmma
kernel of ``csrc/flash_fwd_sm90.cuh``, in f32 of the file's FMA kernel) and
``csrc/flash_attention_bwd.cu`` (``_flash_bwd_dq_kernel`` and
``_flash_bwd_dkv_kernel``, whose bf16 kernels are the TMA + wgmma ones of
``csrc/flash_bwd_sm90.cuh``). They compute what
the Pallas kernels compute: softmax(QKᵀ·D^-½ with a key-padding mask) V with
an online softmax in f32, zero output for a fully masked row, for training
the row logsumexp and the recompute backward of FlashAttention-2, for ring
attention (:mod:`agent_tpu_torch.parallel.ring`) one fold of a K/V block
into carried (m, l, acc) state, and for T5 unscaled scores plus the bucketed
relative-position bias.

Selection is by shape support alone. Every key-padding mask ``[B|1, 1, 1,
Lk]`` with d_head 32, 64 or 128 in bf16 or f32 takes the kernel path, at
any length, serving and training alike: the kernels mask their own ragged
edges, so the reference's length gates (2048 keys to serve, 512 to train)
and tile-divisibility rule (all measured on a TPU) have no counterpart
here. Other shapes (a mask with a query dimension, another d_head or dtype)
take :func:`~agent_tpu_torch.models.layers.dot_product_attention`.

On the kernel path a CUDA tensor launches the kernels, and a CPU tensor
runs the plain versions (:func:`flash_attention_reference`,
:func:`flash_attention_fwd_lse_reference`,
:func:`flash_attention_bwd_reference`, :func:`flash_fold_reference`,
:func:`flash_attention_t5_reference`): the same tile loops in plain
PyTorch, rounding where the kernels round. A CUDA launch that fails raises;
it never falls back to a plain version.

The T5 kernel takes the same shapes (and the reference's 2048-key gate,
measured on a TPU, has no counterpart either), with a ``[num_buckets, H]``
bias table whose ``max_distance`` is at most ``MAX_BIAS_DISTANCE``; other
shapes return None, and the T5 encoder takes its own dense path.
"""

from __future__ import annotations

import contextlib
import ctypes
import threading
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from agent_tpu_torch.models.layers import (
    NEG_INF,
    dot_product_attention,
    is_key_padding_mask,
)

KERNEL_HEAD_DIMS = (32, 64, 128)
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
# Key tile of the plain versions; the bf16 CUDA kernels use the same 64, so
# P is rounded to bf16 against the same running maxima.
BLOCK_K = 64
# Cap on s - lse before exp in the backward: exp(80) is finite in f32, so a
# fully masked row (lse ≈ NEG_INF) never makes inf · 0 (reference :644-649).
EXP_CAP = 80.0
# Largest max_distance the T5 kernel stages in shared memory
# (kMaxBiasDistance in csrc/flash_attention.cu).
MAX_BIAS_DISTANCE = 1024
# The reference's key-length gates (its FLASH_MIN_KEY_LEN for serving and
# T5, FLASH_TRAIN_MIN_KEY_LEN for training): below them it attends densely.
# The port runs its kernels at every length; the gates only decide what a
# batch row with no real key gets (:func:`keyless_rows_dense`).
FLASH_MIN_KEY_LEN = 2048
FLASH_TRAIN_MIN_KEY_LEN = 512

# Per-call tally of the selection: "flash" / "flash_train" = the kernel path
# (the CUDA kernels, or their plain versions for CPU tensors) of serving /
# training, "dense" / "dense_train" = dot-product attention; "ring" /
# "ring_dense" = ring attention over sp (parallel/ring.py) / the shapes it
# sends to dot-product attention; "t5_flash" / "t5_dense" = the T5 kernel
# path / the shapes it hands back to the T5 encoder's dense path;
# "unsharded" = a call on a dp/tp mesh whose batch or heads do not divide
# the mesh (or a sharded model's attention whose heads replicate), run by
# the kernel path whole on the group's first device, where the reference
# runs dense attention.
SELECTION_COUNTS: Dict[str, int] = {"flash": 0, "dense": 0, "flash_train": 0,
                                    "dense_train": 0, "ring": 0, "ring_dense": 0,
                                    "t5_flash": 0, "t5_dense": 0, "unsharded": 0}
# CUDA kernel launches, counted where each kernel is launched and nowhere
# else: a run proves it went through the kernels by reading this.
LAUNCH_COUNTS: Dict[str, int] = {"flash_attention": 0, "flash_attention_fwd_lse": 0,
                                 "flash_attention_bwd_dq": 0, "flash_attention_bwd_dkv": 0,
                                 "flash_fold": 0, "flash_attention_t5": 0}


def selects_flash(seq_len: int, d_head: int, dtype: torch.dtype) -> bool:
    """Shape-only predicate: does self-attention at ``seq_len`` with a
    key-padding mask take the kernel path (see the module docstring)?"""
    return seq_len >= 1 and d_head in KERNEL_HEAD_DIMS and dtype in KERNEL_DTYPES


def _supported(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               mask: torch.Tensor) -> bool:
    B, _, _, D = q.shape
    Lk = k.shape[2]
    return (is_key_padding_mask(mask, B, Lk) and selects_flash(Lk, D, q.dtype)
            and k.dtype == v.dtype == q.dtype)


def flash_fold_supported(q: torch.Tensor, k: torch.Tensor) -> bool:
    """Does the fold kernel take this hop (shape support alone: d_head 32,
    64 or 128, bf16 or f32, one dtype)? The kernel masks its own ragged
    edges, so the reference's tile-divisibility gate has no counterpart."""
    return (q.shape[-1] in KERNEL_HEAD_DIMS and q.dtype in KERNEL_DTYPES
            and k.dtype == q.dtype)


def softmax_scale(d: int) -> float:
    """D^-½ rounded to f32, the scale of every path."""
    return float(np.float32(1.0 / np.sqrt(d)))


def key_keep(mask: torch.Tensor) -> torch.Tensor:
    """Key-padding mask ``[B|1, 1, 1, Lk]`` -> the kernels' int32 ``[B|1,
    Lk]`` (1 = attend), the reference's ``mask3d`` without its middle axis."""
    return (mask[:, 0, 0, :] > 0).to(torch.int32).contiguous()


def initial_state(q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The softmax state before any key: (m, l, acc) = (NEG_INF, 0, 0), f32
    ``[B, H, Lq, 1]``, ``[B, H, Lq, 1]``, ``[B, H, Lq, D]`` on q's device."""
    B, H, Lq, D = q.shape
    m = torch.full((B, H, Lq, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Lq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Lq, D), dtype=torch.float32, device=q.device)
    return m, l, acc


BiasTile = Callable[[int, int], torch.Tensor]  # (k0, k1) -> f32 [1, H, Lq, k1 - k0]


def _fold_tiles(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, keep: torch.Tensor,
                m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor, block_k: int,
                scale: Optional[float] = None, bias_tile: Optional[BiasTile] = None,
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward kernels' tile loop from the state (m, l, acc): the state
    after every key of ``k``/``v``, unnormalised. ``scale`` defaults to
    D^-½; ``bias_tile`` adds an additive score bias after the scale (T5)."""
    Lk = k.shape[2]
    if scale is None:
        scale = softmax_scale(q.shape[-1])
    keep_all = (keep > 0)[:, None, None, :]  # [B|1, 1, 1, Lk]
    qf = q.float()
    for k0 in range(0, Lk, block_k):
        kt = k[:, :, k0:k0 + block_k].float()
        vt = v[:, :, k0:k0 + block_k]
        kp = keep_all[..., k0:k0 + block_k]
        s = torch.matmul(qf, kt.transpose(-1, -2)) * scale
        if bias_tile is not None:
            s = s + bias_tile(k0, k0 + kt.shape[2])
        s = torch.where(kp, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new) * kp
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.matmul(p.to(v.dtype).float(), vt.float())
        m = m_new
    return m, l, acc


def _fwd_tiles(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               keep: torch.Tensor, block_k: int, scale: Optional[float] = None,
               bias_tile: Optional[BiasTile] = None) -> Tuple[torch.Tensor, ...]:
    """The forward kernels' tile loop: (out in q's dtype, m, max(l, 1e-30))
    with m and l f32 ``[B, H, Lq, 1]``."""
    m, l, acc = _fold_tiles(q, k, v, keep, *initial_state(q), block_k, scale, bias_tile)
    den = torch.clamp_min(l, 1e-30)
    return (acc / den).to(q.dtype), m, den


def flash_attention_reference(
    q: torch.Tensor,     # [B, H, Lq, D]
    k: torch.Tensor,     # [B, H, Lk, D]
    v: torch.Tensor,     # [B, H, Lk, D]
    mask: torch.Tensor,  # [B|1, 1, 1, Lk] key-padding mask (> 0 = attend)
    *,
    block_k: int = BLOCK_K,
) -> torch.Tensor:
    """The kernel's tile loop in plain PyTorch: the online softmax over key
    tiles with (m, l, acc) in f32, the scale applied after QKᵀ, masked
    scores set to NEG_INF and their probabilities multiplied by ``keep``, P
    rounded to the input dtype before P·V, output ``acc / max(l, 1e-30)``
    in q's dtype. Products of bf16 inputs are exact in f32, so computing
    them in f32 gives the kernel's bf16-in, f32-accumulate arithmetic."""
    return _fwd_tiles(q, k, v, key_keep(mask), block_k)[0]


def flash_attention_fwd_lse_reference(
    q: torch.Tensor,     # [B, H, Lq, D]
    k: torch.Tensor,     # [B, H, Lk, D]
    v: torch.Tensor,     # [B, H, Lk, D]
    keep: torch.Tensor,  # int32 [B|1, Lk] (> 0 = attend), see key_keep
    *,
    block_k: int = BLOCK_K,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the training forward (reference
    ``_flash_fwd_lse_kernel``): :func:`flash_attention_reference`'s tile
    loop, also returning the row logsumexp ``lse = m + log(max(l, 1e-30))``
    as f32 ``[B, H, Lq, 1]`` (≈ NEG_INF − 69 for a row with no real key)."""
    out, m, den = _fwd_tiles(q, k, v, keep, block_k)
    return out, m + torch.log(den)


def flash_fold_reference(
    q: torch.Tensor,     # [B, H, Lq, D]
    k: torch.Tensor,     # [B, H, Lk, D]
    v: torch.Tensor,     # [B, H, Lk, D]
    keep: torch.Tensor,  # int32 [B|1, Lk] (> 0 = attend), see key_keep
    m: torch.Tensor,     # f32 [B, H, Lq, 1] running max
    l: torch.Tensor,     # f32 [B, H, Lq, 1] running denominator
    acc: torch.Tensor,   # f32 [B, H, Lq, D] running numerator
    *,
    block_k: int = BLOCK_K,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the ring hop (reference ``_flash_fold_kernel``):
    :func:`flash_attention_reference`'s tile loop started from the carried
    state, returning the new (m, l, acc) unnormalised, as new tensors. A
    wholly masked block returns the state unchanged."""
    return _fold_tiles(q, k, v, keep, m, l, acc, block_k)


def distance_bias_table(rel_bias: torch.Tensor, *, bidirectional: bool,
                        max_distance: int) -> torch.Tensor:
    """The T5 kernel's bias input: the learned ``[num_buckets, H]`` table as
    f32 ``[H, 2·max_distance + 1]``, row h holding head h's bias at each
    relative position ``k − q`` in [-max_distance, max_distance] (index
    ``k − q + max_distance``). T5's bucket saturates beyond ±max_distance,
    so clamping k − q into that range gives every score's exact bias."""
    from agent_tpu_torch.models.t5 import distance_buckets

    idx = distance_buckets(bool(bidirectional), int(rel_bias.shape[0]), int(max_distance),
                           rel_bias.device)
    return rel_bias.float()[idx].t().contiguous()


def flash_attention_t5_reference(
    q: torch.Tensor,          # [B, H, Lq, D]
    k: torch.Tensor,          # [B, H, Lk, D]
    v: torch.Tensor,          # [B, H, Lk, D]
    mask: torch.Tensor,       # [B|1, 1, 1, Lk] key-padding mask (> 0 = attend)
    dist_bias: torch.Tensor,  # f32 [H, 2·max_distance + 1], see distance_bias_table
    *,
    max_distance: int,
    scale: float = 1.0,
    block_k: int = BLOCK_K,
) -> torch.Tensor:
    """Plain version of the T5 kernel (reference ``_flash_t5_kernel``):
    :func:`flash_attention_reference`'s tile loop with s = QKᵀ·scale +
    bias[h, clamp(k − q) + max_distance] before the mask, T5's scale being
    1. Output in q's dtype, 0 for a row with no real key."""
    def bias_tile(k0: int, k1: int) -> torch.Tensor:
        return t5_bias_tile(dist_bias, 0, q.shape[2], k0, k1, max_distance=max_distance)[None]

    return _fwd_tiles(q, k, v, key_keep(mask), block_k, float(scale), bias_tile)[0]


def t5_bias_tile(dist_bias: torch.Tensor, q0: int, q1: int, k0: int, k1: int, *,
                 max_distance: int) -> torch.Tensor:
    """The bias of query rows [q0, q1) against keys [k0, k1): f32 ``[H, q1 −
    q0, k1 − k0]``, ``dist_bias[h, clamp(k − q, ±max_distance) +
    max_distance]``, as :func:`flash_attention_t5_reference` adds it."""
    rel = (torch.arange(k0, k1, device=dist_bias.device)[None, :]
           - torch.arange(q0, q1, device=dist_bias.device)[:, None])
    return dist_bias[:, rel.clamp(-max_distance, max_distance) + max_distance]


def t5_constant_bias_index(q0: int, k0: int, max_distance: int, rows: int = 64,
                           keys: int = BLOCK_K) -> Optional[int]:
    """The T5 kernel's constant-tile rule, in its own integer arithmetic:
    when every relative position k − q of query rows [q0, q0 + rows) and
    keys [k0, k0 + keys) lies at or beyond +max_distance (or at or below
    −max_distance), the tile's bias is one entry of the per-distance row,
    whose index this returns (2·max_distance, or 0); otherwise None. The
    kernel (``csrc/flash_fwd_sm90.cuh``) applies it to each warpgroup's 64
    rows and 64-key tile."""
    rel_lo, rel_hi = k0 - (q0 + rows - 1), k0 + keys - 1 - q0
    if rel_lo >= max_distance:
        return 2 * max_distance
    if rel_hi <= -max_distance:
        return 0
    return None


def attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``delta = rowsum(dO ∘ O)`` in f32, ``[B, H, Lq, 1]``, from the
    forward's rounded output (reference :759-761): the plain backward's; the
    CUDA dQ kernel computes it itself."""
    return (do.float() * o.float()).sum(dim=-1, keepdim=True)


def flash_attention_bwd_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    keep: torch.Tensor,  # int32 [B|1, Lk]
    o: torch.Tensor,     # the forward's output [B, H, Lq, D]
    lse: torch.Tensor,   # f32 [B, H, Lq, 1]
    do: torch.Tensor,    # [B, H, Lq, D]
    *,
    block_k: int = BLOCK_K,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernels (reference ``_flash_bwd_res``):
    (dq, dk, dv) in the input dtype. Per key tile, with s = QKᵀ·scale in
    f32: p = where(keep, exp(min(s − lse, 80)), 0), ds = p ∘ (dO·Vᵀ −
    delta); dq += scale · bf16(ds)·K, dk = scale · bf16(ds)ᵀ·Q, dv =
    bf16(p)ᵀ·dO, rounding where the kernels round (bf16 meaning the input
    dtype). A row with no real key has p = 0 everywhere, so it gets zero
    gradients (the reference's documented caveat, :848-851)."""
    D = q.shape[-1]
    Lk = k.shape[2]
    scale = softmax_scale(D)
    keep_all = (keep > 0)[:, None, None, :]
    delta = attention_delta(o, do)
    qf, dof = q.float(), do.float()
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for k0 in range(0, Lk, block_k):
        kt = k[:, :, k0:k0 + block_k].float()
        vt = v[:, :, k0:k0 + block_k].float()
        s = torch.matmul(qf, kt.transpose(-1, -2)) * scale
        p = torch.where(keep_all[..., k0:k0 + block_k],
                        torch.exp(torch.clamp_max(s - lse, EXP_CAP)), 0.0)
        ds = p * (torch.matmul(dof, vt.transpose(-1, -2)) - delta)
        ds_r = ds.to(k.dtype).float()
        dq += scale * torch.matmul(ds_r, kt)
        dks.append(scale * torch.matmul(ds_r.transpose(-1, -2), qf))
        dvs.append(torch.matmul(p.to(do.dtype).float().transpose(-1, -2), dof))
    return (dq.to(q.dtype), torch.cat(dks, dim=2).to(k.dtype),
            torch.cat(dvs, dim=2).to(v.dtype))


# ---- launchers -------------------------------------------------------------

def _check_launch(kernel: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  keep: torch.Tensor, do=None, lse=None, delta=None, o=None,
                  state=None, dist_bias=None, max_distance: int = 0) -> Tuple[int, ...]:
    """Raise ``ValueError`` on anything ``kernel`` does not take: dtypes,
    shapes, non-contiguous or misaligned memory, sizes out of range, and
    tensors on another device than one CUDA device. ``o`` is the forward's
    output (the dQ kernel's delta input), ``state`` the fold's (m, l, acc),
    ``dist_bias`` the T5 kernel's per-distance table for ``max_distance``.
    Returns (B, H, Lq, Lk, D)."""
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    m, l, acc = state if state is not None else (None, None, None)
    if dist_bias is not None and not 1 <= max_distance <= MAX_BIAS_DISTANCE:
        raise ValueError(f"{kernel} kernel: max_distance {max_distance} not in "
                         f"[1, {MAX_BIAS_DISTANCE}]")
    f32_given = [x for x in (lse, delta, m, l, acc, dist_bias) if x is not None]
    given = [x for x in (q, k, v, keep, do, o) if x is not None] + f32_given
    if q.dtype not in KERNEL_DTYPES or any(x.dtype != q.dtype for x in (k, v, do, o)
                                           if x is not None):
        raise ValueError(f"{kernel} kernel: dtypes {q.dtype}/{k.dtype}/{v.dtype} "
                         f"not one of {KERNEL_DTYPES}")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{kernel} kernel: d_head {D} not in {KERNEL_HEAD_DIMS}")
    want = {"k": (k, (B, H, Lk, D)), "v": (v, (B, H, Lk, D)), "do": (do, (B, H, Lq, D)),
            "o": (o, (B, H, Lq, D)), "lse": (lse, (B, H, Lq, 1)),
            "delta": (delta, (B, H, Lq, 1)), "m": (m, (B, H, Lq, 1)),
            "l": (l, (B, H, Lq, 1)), "acc": (acc, (B, H, Lq, D)),
            "dist_bias": (dist_bias, (H, 2 * max_distance + 1))}
    for name, (x, shape) in want.items():
        if x is not None and tuple(x.shape) != shape:
            raise ValueError(f"{kernel} kernel: {name} {tuple(x.shape)} is not {shape}")
    if keep.dtype != torch.int32 or keep.ndim != 2 or keep.shape[0] not in (1, B) \
            or keep.shape[1] != Lk:
        raise ValueError(f"{kernel} kernel: keep {keep.dtype} {tuple(keep.shape)} is "
                         f"not int32 [{B}|1, {Lk}]")
    if any(x.dtype != torch.float32 for x in f32_given):
        raise ValueError(f"{kernel} kernel: lse, delta, the fold state and the bias "
                         "table must be float32")
    if not all(x.is_contiguous() for x in given):
        raise ValueError(f"{kernel} kernel: inputs must be contiguous")
    if any(x.data_ptr() % 16 for x in given if x is not keep):
        raise ValueError(f"{kernel} kernel: inputs must be 16-byte aligned")
    if min(B, H, Lq, Lk) < 1 or B * H * (-(-max(Lq, Lk) // 32)) >= 2 ** 31:
        raise ValueError(f"{kernel} kernel: shape {tuple(q.shape)} out of range")
    if not (q.is_cuda and all(x.device == q.device for x in given)):
        raise ValueError(f"{kernel} kernel: inputs must share one CUDA device")
    return B, H, Lq, Lk, D


def _invoke(lib_name: str, fn_name: str, device: torch.device, *args) -> None:
    """Call ``fn_name`` of kernel library ``lib_name`` with ``args`` (tensors
    by pointer, floats as C float, ints as C int) and the current stream;
    raise on a non-zero cudaError. The tensors' memory may be freed once
    this returns, before the kernel has run: safe, because the caching
    allocator hands it only to later work on the same (current) stream."""
    from agent_tpu_torch.kernels import build

    lib = build.load(lib_name)
    fn = getattr(lib, fn_name)
    fn.argtypes = [ctypes.c_void_p if isinstance(a, torch.Tensor)
                   else ctypes.c_float if isinstance(a, float) else ctypes.c_int
                   for a in args] + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        err = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args),
                 torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        errstr = getattr(lib, f"{lib_name}_error_string")
        errstr.restype = ctypes.c_char_p
        errstr.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{fn_name} kernel launch failed: cudaError {err} "
                           f"({errstr(err).decode()})")


def _dims(q: torch.Tensor, keep: torch.Tensor, Lk: int, D: int) -> tuple:
    """The trailing C arguments every entry takes after the shape."""
    return (Lk if keep.shape[0] > 1 else 0, int(q.dtype == torch.bfloat16), softmax_scale(D))


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            mask: torch.Tensor) -> torch.Tensor:
    """Launch the serving forward on the current stream; raise on anything
    it does not take and on a failed launch."""
    if not is_key_padding_mask(mask, q.shape[0], k.shape[2]):
        raise ValueError(f"flash_attention kernel: mask {tuple(mask.shape)} is not "
                         f"[{q.shape[0]}|1, 1, 1, {k.shape[2]}]")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    keep = key_keep(mask)
    B, H, Lq, Lk, D = _check_launch("flash_attention", q, k, v, keep)
    out = torch.empty_like(q)
    _invoke("flash_attention", "flash_attention_fwd", q.device, q, k, v, keep, out,
            B, H, Lq, Lk, D, *_dims(q, keep, Lk, D))
    LAUNCH_COUNTS["flash_attention"] += 1
    return out


def _launch_t5(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
               dist_bias: torch.Tensor, max_distance: int, scale: float) -> torch.Tensor:
    """Launch the T5 kernel on the current stream; raise on anything it does
    not take and on a failed launch."""
    if not is_key_padding_mask(mask, q.shape[0], k.shape[2]):
        raise ValueError(f"flash_attention_t5 kernel: mask {tuple(mask.shape)} is not "
                         f"[{q.shape[0]}|1, 1, 1, {k.shape[2]}]")
    keep = key_keep(mask)
    B, H, Lq, Lk, D = _check_launch("flash_attention_t5", q, k, v, keep,
                                    dist_bias=dist_bias, max_distance=max_distance)
    out = torch.empty_like(q)
    _invoke("flash_attention", "flash_attention_fwd_t5", q.device, q, k, v, keep, out,
            dist_bias, B, H, Lq, Lk, D, *_dims(q, keep, Lk, D)[:2], float(scale),
            int(max_distance))
    LAUNCH_COUNTS["flash_attention_t5"] += 1
    return out


# The key lengths of the batch that the attention calls of this thread
# serve, as the caller holds them on the host (:func:`keyless_rows`).
_HINT = threading.local()
# More runs of keyless rows than this take the device flag instead.
MAX_KEYLESS_RUNS = 4


@contextlib.contextmanager
def keyless_rows(lengths: Sequence[int]):
    """Within this block the attention calls of this thread serve the batch
    whose per-row key lengths the caller holds on the host (``lengths``,
    ``[B]``; 0 = a row with no real key), so :func:`keyless_rows_dense`
    needs no flag from the mask: a batch without such a row skips the rule,
    and a call over the whole batch replaces those rows alone, by slices,
    with no index sent to the card. A call over part of the batch (a dp
    shard, a micro-batch, beams) that may hold one keeps the device flag.
    Every attention call that reaches the rule inside the block must be
    over this batch or a part of it (an encoder's; a decoder's own
    attention never reaches it). Lengths already on the card give no hint:
    reading them would wait for the card."""
    if isinstance(lengths, torch.Tensor) and lengths.device.type != "cpu":
        yield
        return
    lengths = np.asarray(lengths).reshape(-1)
    dead = np.flatnonzero(lengths == 0)
    # Contiguous runs [a, b) of keyless rows.
    cuts = np.flatnonzero(np.diff(dead) != 1) + 1
    runs = [(int(r[0]), int(r[-1]) + 1) for r in np.split(dead, cuts)] if dead.size else []
    prev = getattr(_HINT, "rows", None)
    _HINT.rows = (lengths.size, runs)
    try:
        yield
    finally:
        _HINT.rows = prev


def keyless_rows_dense(out: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
                       min_key_len: int = FLASH_MIN_KEY_LEN) -> torch.Tensor:
    """``out`` with each batch row whose key mask holds no real key replaced
    by the answer the reference gives it at this key length. Below
    ``min_key_len`` the reference attends densely: every score of such a
    row is ``NEG_INF``, the softmax uniform, the output the mean of V over
    all Lk keys: the dense path's P·V with every probability 1/Lk rounded
    to the dtype, here one such row against V (a batched GEMV). From
    ``min_key_len`` on its kernel gives 0, as the port's does.

    Inside :func:`keyless_rows` the caller's host lengths decide: nothing
    to do without a keyless row, and over the whole batch (no gradient
    asked of ``out``) only those rows' GEMVs, written into ``out`` by
    slices. Otherwise a ``torch.where`` over a ``[B|1]`` flag made on the
    device: no host read, and differentiable in ``out`` and ``v``."""
    Lk = v.shape[2]
    hint = getattr(_HINT, "rows", None)
    if Lk >= min_key_len or (hint is not None and not hint[1]):
        return out
    uniform = torch.full((1, 1, 1, Lk), 1.0 / Lk, dtype=v.dtype, device=v.device)
    if hint is not None:
        n, runs = hint
        if (out.shape[0] == mask.shape[0] == n and not out.requires_grad
                and len(runs) <= MAX_KEYLESS_RUNS):
            for a, b in runs:
                out[a:b] = torch.matmul(uniform, v[a:b]).to(out.dtype)
            return out
    keyless = ~(mask > 0).any(dim=-1, keepdim=True)           # [B|1, 1, 1, 1]
    mean = torch.matmul(uniform, v).to(out.dtype)             # [B, H, 1, D]
    return torch.where(keyless, mean, out)


def _launch_fwd_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    keep: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the training forward: (out, lse f32 [B, H, Lq, 1])."""
    B, H, Lq, Lk, D = _check_launch("flash_attention_fwd_lse", q, k, v, keep)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Lq, 1), dtype=torch.float32, device=q.device)
    _invoke("flash_attention", "flash_attention_fwd_lse", q.device, q, k, v, keep, out,
            lse, B, H, Lq, Lk, D, *_dims(q, keep, Lk, D))
    LAUNCH_COUNTS["flash_attention_fwd_lse"] += 1
    return out, lse


def _launch_fold(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, keep: torch.Tensor,
                 m: torch.Tensor, l: torch.Tensor,
                 acc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the ring hop: fold k/v into (m, l, acc) IN PLACE (each block of
    the kernel owns its query rows) and return the same three tensors."""
    B, H, Lq, Lk, D = _check_launch("flash_fold", q, k, v, keep, state=(m, l, acc))
    _invoke("flash_attention", "flash_attention_fold", q.device, q, k, v, keep, m, l, acc,
            B, H, Lq, Lk, D, *_dims(q, keep, Lk, D))
    LAUNCH_COUNTS["flash_fold"] += 1
    return m, l, acc


def _launch_bwd_dq(q, k, v, keep, do, o, lse) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the dQ kernel: (dq in q's dtype, delta = rowsum(dO ∘ O) f32
    ``[B, H, Lq, 1]``), delta computed by the kernel for the dK/dV kernel."""
    B, H, Lq, Lk, D = _check_launch("flash_attention_bwd_dq", q, k, v, keep, do, lse, o=o)
    dq = torch.empty_like(q)
    delta = torch.empty((B, H, Lq, 1), dtype=torch.float32, device=q.device)
    _invoke("flash_attention_bwd", "flash_attention_bwd_dq", q.device, q, k, v, keep,
            do, o, lse, delta, dq, B, H, Lq, Lk, D, *_dims(q, keep, Lk, D))
    LAUNCH_COUNTS["flash_attention_bwd_dq"] += 1
    return dq, delta


def _launch_bwd_dkv(q, k, v, keep, do, lse, delta) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the dK/dV kernel: (dk, dv) in k's dtype; ``delta`` is the dQ
    kernel's, launched before on the same stream."""
    B, H, Lq, Lk, D = _check_launch("flash_attention_bwd_dkv", q, k, v, keep, do, lse,
                                    delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _invoke("flash_attention_bwd", "flash_attention_bwd_dkv", q.device, q, k, v, keep,
            do, lse, delta, dk, dv, B, H, Lq, Lk, D, *_dims(q, keep, Lk, D))
    LAUNCH_COUNTS["flash_attention_bwd_dkv"] += 1
    return dk, dv


# ---- entry points ------------------------------------------------------------

def flash_attention(
    q: torch.Tensor,     # [B, H, Lq, D]
    k: torch.Tensor,     # [B, H, Lk, D]
    v: torch.Tensor,     # [B, H, Lk, D]
    mask: torch.Tensor,  # [B|1, 1, 1, Lk] key-padding mask (1 = attend)
) -> torch.Tensor:
    """Drop-in ``attn_fn``: the kernel path for supported shapes (CUDA
    kernel, or its plain version for CPU tensors), dense otherwise. A row
    with no real key gets the reference's answer (:func:`keyless_rows_dense`)."""
    supported = _supported(q, k, v, mask)
    SELECTION_COUNTS["flash" if supported else "dense"] += 1
    if not supported:
        return dot_product_attention(q, k, v, mask)
    if q.device.type == "cpu":
        out = flash_attention_reference(q, k, v, mask)
    else:
        out = _launch(q, k, v, mask)
    return keyless_rows_dense(out, v, mask)


def flash_fold(
    q: torch.Tensor,     # [B, H, Lq, D]
    k: torch.Tensor,     # [B, H, Lk, D]
    v: torch.Tensor,     # [B, H, Lk, D]
    mask: torch.Tensor,  # [B|1, 1, 1, Lk] key-padding mask (1 = attend)
    m: torch.Tensor,     # f32 [B, H, Lq, 1]
    l: torch.Tensor,     # f32 [B, H, Lq, 1]
    acc: torch.Tensor,   # f32 [B, H, Lq, D]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One ring hop (reference ``flash_fold``): fold the K/V block into the
    carried softmax state and return the new (m, l, acc), unnormalised. A
    CUDA tensor launches the kernel, which updates the given state tensors
    in place (so they must be f32 and contiguous; it raises otherwise); a
    CPU tensor runs :func:`flash_fold_reference`. Callers use the returned
    tensors either way. For the shapes :func:`flash_fold_supported` takes."""
    if not is_key_padding_mask(mask, q.shape[0], k.shape[2]):
        raise ValueError(f"flash_fold: mask {tuple(mask.shape)} is not "
                         f"[{q.shape[0]}|1, 1, 1, {k.shape[2]}]")
    keep = key_keep(mask)
    if q.device.type == "cpu":
        return flash_fold_reference(q, k, v, keep, m, l, acc)
    return _launch_fold(q.contiguous(), k.contiguous(), v.contiguous(), keep, m, l, acc)


def flash_attention_t5(
    q: torch.Tensor,         # [B, H, Lq, D]
    k: torch.Tensor,         # [B, H, Lk, D]
    v: torch.Tensor,         # [B, H, Lk, D]
    mask: torch.Tensor,      # [B|1, 1, 1, Lk] key-padding mask (1 = attend)
    rel_bias: torch.Tensor,  # [num_buckets, H] learned bias table
    *,
    bidirectional: bool = True,
    max_distance: int = 128,
    scale: float = 1.0,      # T5 attention is unscaled
) -> Optional[torch.Tensor]:
    """T5 attention (reference ``flash_attention_t5``): softmax(QKᵀ·scale +
    the bucketed relative-position bias, key-padding masked) V -> [B, H, Lq,
    D], or **None** for shapes the kernel does not take, so the caller keeps
    its own dense path. A CUDA tensor launches the kernel (or raises), a CPU
    tensor runs :func:`flash_attention_t5_reference`. A row with no real
    key gets the reference's answer (:func:`keyless_rows_dense`)."""
    supported = (_supported(q, k, v, mask) and rel_bias.ndim == 2
                 and rel_bias.shape[1] == q.shape[1] and rel_bias.device == q.device
                 and 1 <= max_distance <= MAX_BIAS_DISTANCE)
    SELECTION_COUNTS["t5_flash" if supported else "t5_dense"] += 1
    if not supported:
        return None
    table = distance_bias_table(rel_bias, bidirectional=bidirectional,
                                max_distance=max_distance)
    if q.device.type == "cpu":
        out = flash_attention_t5_reference(q, k, v, mask, table, max_distance=max_distance,
                                           scale=scale)
    else:
        out = _launch_t5(q.contiguous(), k.contiguous(), v.contiguous(), mask, table,
                         max_distance, scale)
    return keyless_rows_dense(out, v, mask)


class FlashAttentionTrainable(torch.autograd.Function):
    """Attention whose forward and backward are the flash kernels
    (counterpart of the reference's ``_trainable_core`` ``custom_vjp``).

    ``apply(q, k, v, mask, plain)``: ``plain`` runs the plain versions
    (what CPU tensors take); otherwise the CUDA kernels. The forward saves
    (q, k, v, keep, o, lse), q/k/v as the contiguous copies the kernels
    read; the CUDA backward runs the dQ kernel, which also computes
    ``delta``, then the dK/dV kernel (the plain backward computes delta with
    :func:`attention_delta`), and returns no gradient for the mask."""

    @staticmethod
    def forward(ctx, q, k, v, mask, plain: bool):
        keep = key_keep(mask)
        if plain:
            o, lse = flash_attention_fwd_lse_reference(q, k, v, keep)
        else:
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
            o, lse = _launch_fwd_lse(q, k, v, keep)
        ctx.save_for_backward(q, k, v, keep, o, lse)
        ctx.plain = plain
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, keep, o, lse = ctx.saved_tensors
        if ctx.plain:
            dq, dk, dv = flash_attention_bwd_reference(q, k, v, keep, o, lse, do)
        else:
            do = do.contiguous()
            dq, delta = _launch_bwd_dq(q, k, v, keep, do, o, lse)
            dk, dv = _launch_bwd_dkv(q, k, v, keep, do, lse, delta)
        return dq, dk, dv, None, None


def flash_attention_trainable(
    q: torch.Tensor,     # [B, H, Lq, D]
    k: torch.Tensor,     # [B, H, Lk, D]
    v: torch.Tensor,     # [B, H, Lk, D]
    mask: torch.Tensor,  # [B|1, 1, 1, Lk] key-padding mask (1 = attend)
) -> torch.Tensor:
    """Differentiable drop-in ``attn_fn``: the kernels in both directions
    for supported shapes (their plain versions for CPU tensors), dense
    attention (differentiated by autograd) otherwise.

    A row whose mask keeps no key gets the reference's answer at this key
    length (:func:`keyless_rows_dense` with the training gate): below 512
    the mean of V, whose gradient reaches dV as the dense path's uniform
    softmax sends it (dq, dk 0); from 512 on 0 and a zero gradient, as the
    reference's kernel gives."""
    supported = _supported(q, k, v, mask)
    SELECTION_COUNTS["flash_train" if supported else "dense_train"] += 1
    if not supported:
        return dot_product_attention(q, k, v, mask)
    out = FlashAttentionTrainable.apply(q, k, v, mask, q.device.type == "cpu")
    return keyless_rows_dense(out, v, mask, FLASH_TRAIN_MIN_KEY_LEN)


def flash_attention_trainable_reference(q: torch.Tensor, k: torch.Tensor,
                                        v: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The trainable attention through the plain versions on any device:
    the yardstick that a card run holds the kernels against."""
    return FlashAttentionTrainable.apply(q, k, v, mask, True)


def shardable(batch: int, n_heads: int, dp: int, tp: int) -> bool:
    """The reference's ``_wrapper_shardable``: batch over dp, heads over tp."""
    return batch % dp == 0 and n_heads % tp == 0


def mesh_attention(fn_for: Callable[[int, int], Callable], mesh, fallback: Callable):
    """An ``attn_fn`` over a dp/tp mesh (the reference's ``shard_map``
    wrappers): q, k, v [B, H, L, D] and the mask are cut into dp row blocks
    and tp head blocks, shard (i, j) runs ``fn_for(i, j)`` on its device
    (its mesh position at sp 0), and the outputs are put back together on
    q's device. Extra positional arguments (T5's bias table ``[buckets,
    H]``) are cut over heads on their last dim. A shape whose batch or heads
    do not divide runs ``fallback`` whole on q's device, counted under
    ``SELECTION_COUNTS["unsharded"]``. The function's ``shard(i, j)`` gives
    shard (i, j)'s own function, for a model that already runs per shard."""
    shape = mesh.shape
    dp, tp = shape.get("dp", 1), shape.get("tp", 1)

    def attn(q, k, v, mask, *rest, **kw):
        B, H = q.shape[:2]
        if not shardable(B, H, dp, tp):
            SELECTION_COUNTS["unsharded"] += 1
            return fallback(q, k, v, mask, *rest, **kw)
        if mask.shape[0] == 1 and B > 1:
            mask = mask.expand(B, *mask.shape[1:])
        b, h = B // dp, H // tp
        rows = []
        for i in range(dp):
            outs = []
            for j in range(tp):
                dev = mesh.device_at(dp=i, tp=j)

                def put(t):
                    return t.to(dev, non_blocking=True).contiguous()

                hs = slice(j * h, (j + 1) * h)
                bs = slice(i * b, (i + 1) * b)
                o = fn_for(i, j)(put(q[bs, hs]), put(k[bs, hs]), put(v[bs, hs]), put(mask[bs]),
                                 *(put(r[..., hs]) for r in rest), **kw)
                if o is None:  # T5: a shape the kernel hands back
                    return None
                outs.append(o.to(q.device, non_blocking=True))
            rows.append(torch.cat(outs, dim=1))
        return torch.cat(rows, dim=0)

    attn.shard = fn_for
    return attn


def _on_mesh(fn: Callable, mesh) -> Callable:
    """``fn`` itself without a dp/tp mesh, else launched once per shard."""
    if mesh is None or mesh.shape.get("dp", 1) * mesh.shape.get("tp", 1) == 1:
        return fn
    return mesh_attention(lambda i, j: fn, mesh, fn)


def make_flash_attention(mesh=None):
    """The attention function of a mesh without ``sp``: :func:`flash_attention`
    itself on one device; on a dp/tp mesh the kernel launched once per
    shard on the shard's device, with its batch rows and heads
    (:func:`mesh_attention`)."""
    return _on_mesh(flash_attention, mesh)


def make_flash_attention_trainable(mesh=None):
    """The differentiable attention function of a mesh without ``sp``:
    :func:`flash_attention_trainable` itself, or per dp/tp shard."""
    return _on_mesh(flash_attention_trainable, mesh)


def make_flash_attention_t5(mesh=None):
    """The T5 attention function: :func:`flash_attention_t5` itself, or on
    a dp/tp mesh per shard (batch over dp, heads and the bias table's head
    columns over tp), as the reference's T5 wrapper. Over ``sp`` the
    reference runs it unsharded too (no ring for T5)."""
    return _on_mesh(flash_attention_t5, mesh)
