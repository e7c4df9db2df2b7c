"""Training step for the encoder classifier — counterpart of
``agent_tpu.models.train`` (``cross_entropy_loss``, ``make_train_step``).

The model is an :class:`~agent_tpu_torch.models.encoder.Encoder` in its
training form (f32 master parameters, cast to the compute dtype at use), or
a :class:`~agent_tpu_torch.models.encoder.ShardedEncoder` over a dp/tp
mesh: the loss is the mean over the whole batch (the logits of every dp
replica), dp replicas on one device share their weights and so sum their
gradients, and after the backward ``sync_grads`` sums each replicated
leaf's gradient over its copies, so the update equals the one-device
update up to f32 summation order. AdamW runs on each shard's own pieces.
The optimizer is ``optax.adamw(lr)`` with optax's defaults: betas (0.9,
0.999), eps 1e-8 and weight decay 1e-4 (not torch's 1e-2) on every leaf,
which ``torch.optim.AdamW`` with those arguments computes: both take
``p ← p − lr·(m̂ / (√v̂ + eps) + wd·p)``.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Tuple

import torch
import torch.nn.functional as F

from agent_tpu_torch.models import layers
from agent_tpu_torch.models.layers import AttnFn

# optax.adamw's defaults (the reference calls ``optax.adamw(lr)``).
ADAMW_BETAS = (0.9, 0.999)
ADAMW_EPS = 1e-8
ADAMW_WEIGHT_DECAY = 1e-4
# Switch Transformer's load-balance coefficient (the reference's): an MoE
# router trained without the aux term collapses onto one expert.
MOE_AUX_WEIGHT = 0.01

OptimizerFactory = Callable[[Iterable[torch.nn.Parameter]], torch.optim.Optimizer]


def adamw(lr: float) -> OptimizerFactory:
    """``optax.adamw(lr)`` as a factory of ``torch.optim.AdamW`` over a
    model's parameters (optax's transformation holds no parameters; a torch
    optimizer does, so it is built per model by ``init_state``)."""
    return lambda params: torch.optim.AdamW(params, lr=lr, betas=ADAMW_BETAS,
                                            eps=ADAMW_EPS,
                                            weight_decay=ADAMW_WEIGHT_DECAY)


def cross_entropy_loss(model, ids: torch.Tensor, mask: torch.Tensor,
                       labels: torch.Tensor, remat: bool = False,
                       attn_fn: Optional[AttnFn] = None) -> torch.Tensor:
    """Mean NLL of ``labels`` under the f32 log-softmax of the logits; an
    MoE model adds ``MOE_AUX_WEIGHT`` times its Switch aux loss."""
    moe = getattr(model.cfg, "moe_experts", 0) > 0
    logits, aux = model(ids, mask, attn_fn or layers.dot_product_attention, remat,
                        with_aux=True)
    logp = F.log_softmax(logits.float(), dim=-1)
    loss = -logp.gather(1, labels.long()[:, None])[:, 0].mean()
    return loss + MOE_AUX_WEIGHT * aux if moe else loss


def make_train_step(cfg, optimizer: Optional[OptimizerFactory] = None,
                    remat: bool = False, attn_fn: Optional[AttnFn] = None):
    """Build ``(init_state, step)``.

    ``init_state(model)`` -> the optimizer over the model's parameters;
    ``step(model, opt, ids, mask, labels)`` -> (model, opt, loss), loss a
    0-dim f32 tensor on the device (reading it waits for the step).

    The step updates the model's parameters and the optimizer's state in
    place, where the reference's jitted step donates both buffers: the
    returned model and optimizer are the ones passed in. It records
    gradients even when the caller is in ``no_grad`` or ``inference_mode``.

    ``attn_fn`` must be differentiable: ``runtime.train_attention_fn()``
    (the flash kernels in both directions) or dense attention (default).
    ``remat=True`` recomputes each block in the backward. An MoE config
    trains with the Switch aux loss (:func:`cross_entropy_loss`).
    """
    optimizer = optimizer or adamw(1e-3)

    def init_state(model) -> torch.optim.Optimizer:
        return optimizer(model.parameters())

    def step(model, opt: torch.optim.Optimizer, ids: torch.Tensor, mask: torch.Tensor,
             labels: torch.Tensor) -> Tuple[object, torch.optim.Optimizer, torch.Tensor]:
        with torch.inference_mode(False), torch.enable_grad():
            opt.zero_grad(set_to_none=True)
            loss = cross_entropy_loss(model, ids, mask, labels, remat, attn_fn)
            loss.backward()
            if hasattr(model, "sync_grads"):
                model.sync_grads()
            opt.step()
        return model, opt, loss.detach()

    return init_state, step
