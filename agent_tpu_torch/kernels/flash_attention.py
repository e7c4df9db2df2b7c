"""Flash attention: the hand-written Hopper kernel, its plain version, and
the selection between them and dense attention.

Counterpart of ``agent_tpu.kernels.flash_attention`` (``flash_attention``,
``selects_flash``, ``SELECTION_COUNTS``, ``make_flash_attention``). The
kernel itself is ``csrc/flash_attention.cu``; it replaces the Pallas kernel
``_flash_kernel`` and computes the same function: softmax(QKᵀ·D^-½ with a
key-padding mask) V with an online softmax in f32, zero output for a fully
masked row.

Selection is by shape support alone. Every key-padding mask ``[B|1, 1, 1,
Lk]`` with d_head 32, 64 or 128 in bf16 or f32 takes the kernel path, at
any length: the kernel masks its own ragged edge, so the reference's
length gate and tile-divisibility rule (both measured on a TPU) have no
counterpart here. Other shapes (a mask with a query dimension, another
d_head or dtype) take :func:`~agent_tpu_torch.models.layers.dot_product_attention`.

On the kernel path a CUDA tensor launches the kernel, and a CPU tensor runs
:func:`flash_attention_reference`, the same tile loop in plain PyTorch.
A CUDA launch that fails raises; it never falls back to the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np
import torch

from agent_tpu_torch.models.layers import (
    NEG_INF,
    dot_product_attention,
    is_key_padding_mask,
)

KERNEL_HEAD_DIMS = (32, 64, 128)
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
# Key tile of the plain version; the bf16 CUDA kernel uses the same 64, so
# P is rounded to bf16 against the same running maxima.
BLOCK_K = 64

# Per-call tally of the selection: "flash" = the kernel path (the CUDA
# kernel, or its plain version for CPU tensors), "dense" = dot-product.
SELECTION_COUNTS: Dict[str, int] = {"flash": 0, "dense": 0}
# CUDA kernel launches, counted where the kernel is launched and nowhere
# else: a run proves it went through the kernel by reading this.
LAUNCH_COUNTS: Dict[str, int] = {"flash_attention": 0}


def selects_flash(seq_len: int, d_head: int, dtype: torch.dtype) -> bool:
    """Shape-only predicate: does self-attention at ``seq_len`` with a
    key-padding mask take the kernel path (see the module docstring)?"""
    return seq_len >= 1 and d_head in KERNEL_HEAD_DIMS and dtype in KERNEL_DTYPES


def _scale(d: int) -> float:
    return float(np.float32(1.0 / np.sqrt(d)))


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
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    scale = _scale(D)
    keep_all = (mask[:, 0, 0, :] > 0)[:, None, None, :]  # [B|1, 1, 1, Lk]
    qf = q.float()
    m = torch.full((B, H, Lq, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Lq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Lq, D), dtype=torch.float32, device=q.device)
    for k0 in range(0, Lk, block_k):
        kt = k[:, :, k0:k0 + block_k].float()
        vt = v[:, :, k0:k0 + block_k]
        keep = keep_all[..., k0:k0 + block_k]
        s = torch.matmul(qf, kt.transpose(-1, -2)) * scale
        s = torch.where(keep, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new) * keep
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.matmul(p.to(v.dtype).float(), vt.float())
        m = m_new
    return (acc / torch.clamp_min(l, 1e-30)).to(q.dtype)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            mask: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream; raise on anything it
    does not take and on a failed launch."""
    from agent_tpu_torch.kernels import build

    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    if not (q.is_cuda and k.device == q.device and v.device == q.device
            and mask.device == q.device):
        raise ValueError("flash_attention kernel: q, k, v, mask must share one CUDA device")
    if q.dtype not in KERNEL_DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention kernel: dtypes {q.dtype}/{k.dtype}/{v.dtype} "
                         f"not one of {KERNEL_DTYPES}")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: d_head {D} not in {KERNEL_HEAD_DIMS}")
    if k.shape != (B, H, Lk, D) or v.shape != (B, H, Lk, D):
        raise ValueError(f"flash_attention kernel: k {tuple(k.shape)}, v {tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if not is_key_padding_mask(mask, B, Lk):
        raise ValueError(f"flash_attention kernel: mask {tuple(mask.shape)} is not "
                         f"[{B}|1, 1, 1, {Lk}]")
    if min(B, H, Lq, Lk) < 1 or B * H * (-(-Lq // 32)) >= 2 ** 31:
        raise ValueError(f"flash_attention kernel: shape {tuple(q.shape)} out of range")
    # The temporaries below may be freed once this returns, before the kernel
    # has run: safe, because the caching allocator hands their memory only to
    # later work on the same (current) stream.
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    keep = (mask[:, 0, 0, :] > 0).to(torch.int32).contiguous()  # [B|1, Lk]
    out = torch.empty_like(q)
    lib = build.load("flash_attention")
    fn = lib.flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_float,
                                                                 ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), keep.data_ptr(),
                 out.data_ptr(), B, H, Lq, Lk, D, Lk if keep.shape[0] > 1 else 0,
                 int(q.dtype == torch.bfloat16), _scale(D),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err} ({msg})")
    LAUNCH_COUNTS["flash_attention"] += 1
    return out


def flash_attention(
    q: torch.Tensor,     # [B, H, Lq, D]
    k: torch.Tensor,     # [B, H, Lk, D]
    v: torch.Tensor,     # [B, H, Lk, D]
    mask: torch.Tensor,  # [B|1, 1, 1, Lk] key-padding mask (1 = attend)
) -> torch.Tensor:
    """Drop-in ``attn_fn``: the kernel path for supported shapes (CUDA
    kernel, or its plain version for CPU tensors), dense otherwise."""
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    supported = (is_key_padding_mask(mask, B, Lk) and selects_flash(Lk, D, q.dtype)
                 and k.dtype == v.dtype == q.dtype)
    SELECTION_COUNTS["flash" if supported else "dense"] += 1
    if not supported:
        return dot_product_attention(q, k, v, mask)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, mask)
    return _launch(q, k, v, mask)


def make_flash_attention(mesh=None):
    """The attention function for a mesh: on one card, :func:`flash_attention`
    itself (the reference wraps its kernel in ``shard_map`` for dp/tp
    meshes; the port has no mesh yet)."""
    return flash_attention
