"""Train and eval steps, the optimizer and its schedule: twin of
`rift_tpu/train/steps.py`.

The reference's optax chain, in torch:
- `clip_by_global_norm(grad_clip)` when set: every gradient times
  grad_clip/‖g‖ once the global norm ‖g‖ reaches grad_clip (optax's rule;
  torch's `clip_grad_norm_` divides by ‖g‖ + 1e-6 instead);
- `add_decayed_weights(weight_decay)` before `adam`: torch's
  `Adam(weight_decay=)`, which adds weight_decay·p to the gradient of every
  parameter (BN scale and bias and the PVConv coefficients too) before the
  moments;
- `adam(schedule)`: β = (0.9, 0.999), eps outside the square root,
  m̂/(√v̂ + 1e-8), as torch's Adam computes it;
- `cosine_decay_schedule(lr, T)`: lr·½(1 + cos(π·min(t, T)/T)), t counted
  from 0 at the first update, as optax counts; T = num_epochs ×
  steps_per_epoch.

A step runs inside `ops/precision.py:f32_geometry`, so cuDNN's Conv3d
forward and backward stay in f32 on the card. A bf16 model
(`model.dtype='bfloat16'`, the reference's `dtype` model) keeps f32
parameters and f32 Adam moments, and computes its conv and MLP stacks in
bf16 (cuDNN's bf16 Conv3d forward and backward; TF32 concerns f32 alone,
so the context leaves them as they are); its head, and so the logits and
the cross-entropy, stay f32, as flax's `Dense` without a `dtype` promotes
the bf16 features to its f32 kernel.

Inside a profiler window (`tracing.py`) a step records three top-level
spans on the batch's device: `train.forward` (the train-mode forward, the
loss and the accuracy), `train.backward` (`zero_grad` and the backward)
and `train.update` (the clip, the rate and the optimizer's step). They
leave the arithmetic as it is.
"""
from __future__ import annotations

import math
from collections.abc import Callable
from dataclasses import dataclass

import torch
from torch import nn
from torch.nn import functional as F

from .. import tracing
from ..nn.batch_norm import BatchNorm
from ..ops.precision import f32_geometry
from .config import ExperimentConfig

# flax's lecun_normal: a normal truncated at 2σ, rescaled to variance 1/fan_in.
_TRUNC_STD = 0.87962566103423978


@dataclass
class TrainState:
    """The model (parameters and BN statistics), its optimizer, the learning
    rate per update index, the clip norm, and the number of updates made.
    A state restored for evaluation has no optimizer and no schedule."""
    model: nn.Module
    optimizer: torch.optim.Optimizer | None
    schedule: Callable[[int], float] | None
    grad_clip: float | None = None
    step: int = 0


def init_params(model: nn.Module, seed: int) -> None:
    """flax's default initializers, drawn from a generator seeded with
    `seed`: Dense and Conv kernels lecun-normal, biases 0, BN scale 1 and
    bias 0, PVConv coefficients 1."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, (nn.Linear, nn.Conv3d)):
                w = module.weight
                std = math.sqrt(1.0 / w[0].numel()) / _TRUNC_STD
                nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=gen)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, BatchNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
                module.running_mean.zero_()
                module.running_var.fill_(1.0)
        for name, p in model.named_parameters():
            if name.endswith("coefficient"):
                p.fill_(1.0)


def make_optimizer(model: nn.Module, config: ExperimentConfig, steps_per_epoch: int
                   ) -> tuple[torch.optim.Optimizer, Callable[[int], float]]:
    """Adam with L2-in-gradient weight decay, and the learning rate of the
    update with index t (cosine or constant)."""
    optim = config.optim
    total = max(optim.num_epochs * steps_per_epoch, 1)
    optimizer = torch.optim.Adam(model.parameters(), lr=optim.lr, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=optim.weight_decay or 0.0)
    if optim.schedule == "cosine":
        def schedule(t: int) -> float:
            return optim.lr * 0.5 * (1.0 + math.cos(math.pi * min(t, total) / total))
    else:
        def schedule(t: int) -> float:
            return optim.lr
    return optimizer, schedule


def create_state(model: nn.Module, config: ExperimentConfig, steps_per_epoch: int,
                 device: torch.device, seed: int = 0) -> TrainState:
    """Initialize `model` from `seed` on `device` and build its optimizer."""
    init_params(model, seed)
    model.to(device)
    optimizer, schedule = make_optimizer(model, config, steps_per_epoch)
    return TrainState(model, optimizer, schedule, config.optim.grad_clip)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The mean over every labelled row of −log softmax at the label: logits
    [b, c] with labels [b] (classification), or [b, n, c] with [b, n]
    (segmentation: the mean over all b·n points). The rows are flattened,
    since `F.cross_entropy` reads axis 1 as the classes."""
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1).long())


def clip_by_global_norm(params, max_norm: float) -> None:
    """optax's clip_by_global_norm on the `.grad` of `params`, in place and
    without a host sync."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


def forward_backward(state: TrainState, clouds: torch.Tensor, labels: torch.Tensor,
                     generator: torch.Generator | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The train-mode forward and the backward of the batch's mean
    cross-entropy: (loss, accuracy) as 0-d tensors (no host sync), the
    gradients in each parameter's `.grad`."""
    model = state.model
    model.train()
    with f32_geometry():
        with tracing.span("train.forward", clouds.device):
            logits = model(clouds, generator=generator)
            loss = cross_entropy(logits, labels)
            acc = (logits.detach().argmax(-1) == labels).float().mean()
        with tracing.span("train.backward", clouds.device):
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
    return loss.detach(), acc


def apply_update(state: TrainState) -> None:
    """The optimizer's update from the gradients in `.grad` (clipped first
    when `grad_clip` is set), at the rate of update `state.step`, which it
    then counts."""
    with tracing.span("train.update", next(state.model.parameters()).device):
        if state.grad_clip:
            clip_by_global_norm(state.model.parameters(), state.grad_clip)
        for group in state.optimizer.param_groups:
            group["lr"] = state.schedule(state.step)
        state.optimizer.step()
    state.step += 1


def train_step(state: TrainState, clouds: torch.Tensor, labels: torch.Tensor,
               generator: torch.Generator | None = None) -> dict:
    """One update of `state` in place on a batch: the classifier's (clouds
    [b, n, 6], labels [b]) or the segmentation model's (clouds [b, n, 22],
    part labels [b, n]; the reference's `seg_step`). `generator` draws the
    dropout masks. Returns the batch's loss and accuracy (per cloud or per
    point) as 0-d tensors (no host sync); the gradients stay in each
    parameter's `.grad`."""
    loss, acc = forward_backward(state, clouds, labels, generator)
    apply_update(state)
    return {"loss": loss, "acc": acc}


def eval_step(state: TrainState, clouds: torch.Tensor) -> torch.Tensor:
    """Eval-mode logits, [b, num_classes] or per point [b, n, num_classes]
    (running BN statistics, no dropout)."""
    model = state.model
    model.eval()
    with torch.no_grad(), f32_geometry():
        return model(clouds)
