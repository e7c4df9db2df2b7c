"""Switch mixture-of-experts FFN — counterpart of ``agent_tpu.models.moe``.

Top-1 routing over ``n_experts`` in f32, a static per-expert capacity per
routing group (tokens over it are dropped: their output is zero and the
residual carries them), the combine weighted by the gate, and the Switch
load-balancing aux loss with pad tokens left out of its statistics.

The reference dispatches with dense one-hot einsums (``[G, T, E, C]``
dispatch and combine tensors). This port computes the same function with
indices: each kept token's slot in an expert-major ``[E, G, C]`` layout is
``(expert · G + group) · C + position``, the expert inputs are a gather of
the tokens into those slots, and the combine gathers each token's slot
back, times its gate. It drops the same tokens, in the same in-group order,
keeps the gradient into the gate and x, and at BERT-base width avoids
materialising about 0.7 GB of one-hots a layer. The slot of each token and
the token of each slot are inverse maps, so each gather's gradient is a
gather by the other map (:class:`Route`): autograd's own backward of an
index scatter-adds, and the many indices that share the zero row (empty
slots, dropped tokens) serialise it, which made it most of an MoE training
step's device time on the H100.

Weights are deterministic from the model id: :func:`init_moe_ffn` draws
the reference's arrays through the port's ``prng``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from agent_tpu_torch.models import layers, prng, quant

# Tokens routed together, the reference's default: one seq-512 row a group
# (capacity 80 at 8 experts and factor 1.25). Capacity, and the drops,
# depend only on the competition inside a group.
MOE_GROUP_TOKENS = 512


@dataclass(frozen=True)
class MoeConfig:
    d_model: int = 128
    d_ff: int = 512
    n_experts: int = 4
    capacity_factor: float = 1.25
    dtype: str = "float32"

    @property
    def compute_dtype(self) -> torch.dtype:
        return layers.compute_dtype(self.dtype)

    def capacity(self, n_tokens: int) -> int:
        """Static per-expert token capacity of a group of ``n_tokens``."""
        return max(1, int(np.ceil(n_tokens / self.n_experts * self.capacity_factor)))


def init_moe_ffn(key: np.ndarray, cfg: MoeConfig) -> Dict[str, np.ndarray]:
    """Router ``[d, E]`` and expert-stacked ``wi`` ``[E, d, f]``, ``wo``
    ``[E, f, d]`` (f32 numpy), equal to the reference's for the same key."""
    kr, k1, k2 = prng.split(key, 3)
    scale_in = np.float32(1.0 / np.sqrt(cfg.d_model))
    scale_out = np.float32(1.0 / np.sqrt(cfg.d_ff))
    return {
        "router": {"w": prng.normal(kr, (cfg.d_model, cfg.n_experts)) * scale_in},
        "wi": prng.normal(k1, (cfg.n_experts, cfg.d_model, cfg.d_ff)) * scale_in,
        "wo": prng.normal(k2, (cfg.n_experts, cfg.d_ff, cfg.d_model)) * scale_out,
    }


def _take(src: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Rows ``src[index]`` of [n, d] ``src``, the index ``n`` reading zeros."""
    return torch.cat([src, src.new_zeros((1, src.shape[1]))])[index]


class Route(torch.autograd.Function):
    """Rows of ``src`` gathered by ``index``, whose gradient is the output's
    gradient gathered by ``inverse``: the two maps are each other's inverse
    on the rows they share, and every other row reads zero (the index one
    past the end)."""

    @staticmethod
    def forward(ctx, src: torch.Tensor, index: torch.Tensor, inverse: torch.Tensor):
        ctx.save_for_backward(inverse)
        return _take(src, index)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (inverse,) = ctx.saved_tensors
        return _take(grad, inverse), None, None


class Router(nn.Module):
    """The router's ``w`` [d, E], f32 in both forms (the reference reads it
    in f32 whatever the compute dtype)."""

    def __init__(self, d_model: int, n_experts: int, device=None,
                 trainable: bool = False) -> None:
        super().__init__()
        self.w = layers.make_weight((d_model, n_experts), torch.float32, device, trainable)


class MoeFFN(nn.Module):
    """The Switch FFN: ``router.w``, ``wi``, ``wo`` (the reference's leaf
    names; ``wi``/``wo`` become :class:`~agent_tpu_torch.models.quant.QuantLeaf`
    under ``quant.quantize_``). Serving form: experts in the compute dtype,
    frozen; training form: f32 master weights."""

    def __init__(self, cfg: MoeConfig, device=None, trainable: bool = False) -> None:
        super().__init__()
        self.cfg = cfg
        self.dtype = cfg.compute_dtype
        e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
        self.router = Router(d, e, device, trainable)
        self.wi = layers.make_weight((e, d, f), self.dtype, device, trainable)
        self.wo = layers.make_weight((e, f, d), self.dtype, device, trainable)

    def _experts(self, w, x: torch.Tensor) -> torch.Tensor:
        """x [E, N, in] through each expert's matrix -> [E, N, out]."""
        if isinstance(w, quant.QuantLeaf):
            return quant.moe_expert(w.p, x, self.dtype)
        return torch.bmm(x, w.to(self.dtype))

    def expert_ffn(self, x: torch.Tensor) -> torch.Tensor:
        """The FFN of every expert this module holds: x [E, N, d] -> [E, N, d]."""
        return self._experts(self.wo, layers.gelu_tanh_as_reference(self._experts(self.wi, x)))

    def forward(self, x: torch.Tensor, group_size: int = 0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [T, d] -> (y [T, d] in x's dtype, aux f32 scalar). ``y`` is
        zero for a dropped token (callers add the residual)."""
        return self.dispatch(x, group_size, [self])

    def _route(self, x: torch.Tensor, group_size: int):
        """Zero-pad x [T, d] to whole routing groups and route it on the
        router: (padded x, probs [g, t, E], expert [g, t], one-hot
        [g, t, E], each token's place in its expert's in-group queue from 0
        [g, t], capacity C). A place >= C is a capacity drop."""
        T, d = x.shape
        group = min(T, group_size or MOE_GROUP_TOKENS)
        pad = (-T) % group
        if pad:
            x = F.pad(x, (0, 0, 0, pad))
        n_g = (T + pad) // group
        xg = x.reshape(n_g, group, d)
        probs = torch.softmax(torch.matmul(xg.float(), self.router.w.float()), dim=-1)
        expert = probs.argmax(dim=-1)
        onehot = F.one_hot(expert, self.cfg.n_experts).float()
        pos = (torch.cumsum(onehot, dim=1) * onehot).sum(-1).long() - 1
        return x, probs, expert, onehot, pos, self.cfg.capacity(group)

    def routes(self, x: torch.Tensor, group_size: int = 0
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The routing :meth:`dispatch` decides for x [T, d]: each token's
        expert [T] and whether it keeps a capacity slot [T] (False = dropped)."""
        T = x.shape[0]
        _, _, expert, _, pos, C = self._route(x, group_size)
        return expert.reshape(-1)[:T], (pos < C).reshape(-1)[:T]

    def dispatch(self, x: torch.Tensor, group_size: int, experts: List["MoeFFN"]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """:meth:`forward` with the experts held by ``experts``, the ep
        shards in order (each holds E/ep consecutive experts, on its own
        device): routing, capacity and drops are decided here, on this
        module's replicated router, before any slot leaves; each shard
        computes its experts' slots and sends them back."""
        cfg, dtype = self.cfg, self.dtype
        T, d = x.shape
        E = cfg.n_experts
        if T == 0:  # nothing to route; the aux loss is defined as 0
            return x, x.new_zeros((), dtype=torch.float32)
        x, probs, expert, onehot, pos, C = self._route(x, group_size)
        n_g, group = expert.shape
        gate = probs.gather(-1, expert[..., None])[..., 0]
        n_slots = E * n_g * C
        groups = torch.arange(n_g, device=x.device)[:, None]
        # Expert-major slot of each kept token; a dropped one goes to the
        # trash slot n_slots, whose output row is zero.
        slot = torch.where(pos < C, (expert * n_g + groups) * C + pos,
                           torch.full_like(pos, n_slots)).reshape(-1)
        # The token each slot holds; an empty slot reads the zero row.
        token = torch.full((n_slots + 1,), n_g * group, dtype=torch.long, device=x.device)
        token.scatter_(0, slot, torch.arange(n_g * group, device=x.device))
        token = token[:n_slots]
        expert_in = Route.apply(x.to(dtype), token, slot).view(E, n_g * C, d)
        out = run_experts(experts, expert_in).reshape(n_slots, d)
        y = gate.reshape(-1, 1).to(dtype) * Route.apply(out, slot, token)
        y = y[:T]

        # Switch aux loss: E · Σ_e fraction_e · mean_prob_e per group,
        # averaged over groups, over real tokens only.
        valid = (torch.arange(n_g * group, device=x.device).reshape(n_g, group) < T)[..., None]
        valid = valid.float()
        vcount = valid.sum(dim=1).clamp_min(1.0)                         # [g, 1]
        fraction = (onehot * valid).sum(dim=1) / vcount                  # [g, E]
        mean_prob = (probs * valid).sum(dim=1) / vcount
        aux = ((fraction * mean_prob).sum(dim=-1) * E).mean()
        return y.to(x.dtype), aux


def run_experts(experts: List[MoeFFN], expert_in: torch.Tensor) -> torch.Tensor:
    """Expert-major slots [E, N, d] through the ep shards: shard k takes the
    slots of its E/ep experts on its device, and the outputs come back to
    ``expert_in``'s device in expert order."""
    if len(experts) == 1:
        return experts[0].expert_ffn(expert_in)
    outs = [m.expert_ffn(part.to(_device(m), non_blocking=True))
            .to(expert_in.device, non_blocking=True)
            for m, part in zip(experts, expert_in.chunk(len(experts)))]
    return torch.cat(outs)


def _device(m: MoeFFN) -> torch.device:
    """The device of the experts ``m`` holds."""
    return m.wi.w_scale.device if isinstance(m.wi, quant.QuantLeaf) else m.wi.device


class MoeBlock(nn.Module):
    """Pre-LN residual MoE block (the reference's ``moe_block``): ``ln``
    then ``moe``; [B, L, d] -> (x + y, aux)."""

    def __init__(self, cfg: MoeConfig, device=None, trainable: bool = False) -> None:
        super().__init__()
        self.ln = layers.LayerNorm(cfg.d_model, device, trainable)
        self.moe = MoeFFN(cfg, device, trainable)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        B, L, d = x.shape
        y, aux = self.moe(self.ln(x).reshape(B * L, d))
        return x + y.reshape(B, L, d), aux


def init_moe_block(key: np.ndarray, cfg: MoeConfig) -> Dict[str, np.ndarray]:
    return {"ln": layers.init_layer_norm(cfg.d_model), "moe": init_moe_ffn(key, cfg)}


def moe_cfg_of(cfg) -> Optional[MoeConfig]:
    """The block-level MoE config of an encoder config with ``moe_experts``
    > 0, else None."""
    if getattr(cfg, "moe_experts", 0) <= 0:
        return None
    return MoeConfig(d_model=cfg.d_model, d_ff=cfg.d_ff, n_experts=cfg.moe_experts,
                     capacity_factor=cfg.moe_capacity_factor, dtype=cfg.dtype)
