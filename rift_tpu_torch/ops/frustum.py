"""Frustum-PointNet box utilities and loss, twin of `rift_tpu/ops/frustum.py`:
`get_box_corners_3d` and the composite `frustum_pointnet_loss` as a pure
function of dicts of predictions and targets (the module's buffers, the
heading bin centres and the size templates, are arguments). Batched,
branchless and differentiable: the per-sample picks are `gather`s.
"""
from __future__ import annotations

import math

import torch

from .losses import huber_loss

Tensor = torch.Tensor


def _roty(c: Tensor, s: Tensor) -> Tensor:
    """Rotations [b, 3, 3] about +y from their cosines and sines [b]."""
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, z, s], -1),
                        torch.stack([z, o, z], -1),
                        torch.stack([-s, z, c], -1)], -2)


def get_box_corners_3d(centers: Tensor, headings: Tensor, sizes: Tensor,
                       with_flip: bool = False):
    """Corners [b, 3, 8] of upright 3-D boxes rotated about +y: centers
    [b, 3], headings [b], sizes [b, 3] (l, w, h; x from l, y from h, z from
    w, counter-clockwise corner order); with `with_flip` also the corners
    at heading + π."""
    l, w, h = sizes[:, 0], sizes[:, 1], sizes[:, 2]
    kw = dict(dtype=centers.dtype, device=centers.device)
    sx = torch.tensor([1, 1, -1, -1, 1, 1, -1, -1], **kw)
    sy = torch.tensor([1, 1, 1, 1, -1, -1, -1, -1], **kw)
    sz = torch.tensor([1, -1, -1, 1, 1, -1, -1, 1], **kw)
    corners = torch.stack([0.5 * l[:, None] * sx, 0.5 * h[:, None] * sy,
                           0.5 * w[:, None] * sz], dim=1)  # [b, 3, 8]
    c, s = torch.cos(headings), torch.sin(headings)
    out = _roty(c, s) @ corners + centers[:, :, None]
    if with_flip:  # heading + π: cos -> −cos, sin -> −sin
        return out, _roty(-c, -s) @ corners + centers[:, :, None]
    return out


def _softmax_xent(logits: Tensor, labels: Tensor) -> Tensor:
    """Mean cross entropy of class logits on dim 1 ([b, C] or [b, C, n])
    against integer labels ([b] or [b, n])."""
    logp = torch.log_softmax(logits, dim=1)
    return -torch.gather(logp, 1, labels[:, None].long()).mean()


def _pick(x: Tensor, i: Tensor) -> Tensor:
    """x[b, i[b], ...] for x [b, K, ...] and i [b]."""
    idx = i.view(-1, 1, *([1] * (x.dim() - 2))).expand(-1, 1, *x.shape[2:])
    return torch.gather(x, 1, idx)[:, 0]


def frustum_pointnet_loss(inputs: dict, targets: dict, heading_angle_bin_centers: Tensor,
                          size_templates: Tensor, box_loss_weight: float = 1.0,
                          corners_loss_weight: float = 10.0,
                          heading_residual_loss_weight: float = 20.0,
                          size_residual_loss_weight: float = 20.0) -> Tensor:
    """The composite Frustum-PointNet loss.

    inputs: mask_logits [b, 2, n], center_reg and center [b, 3],
    heading_scores, heading_residuals(_normalized) [b, NH], size_scores
    [b, NS], size_residuals(_normalized) [b, NS, 3]. targets: mask_logits
    [b, n] int, center [b, 3], heading_bin_id [b], heading_residual [b],
    size_template_id [b], size_residual [b, 3].
    """
    num_heading_bins = heading_angle_bin_centers.shape[0]
    bin_id = targets["heading_bin_id"].long()
    size_id = targets["size_template_id"].long()

    mask_loss = _softmax_xent(inputs["mask_logits"], targets["mask_logits"])
    heading_loss = _softmax_xent(inputs["heading_scores"], bin_id)
    size_loss = _softmax_xent(inputs["size_scores"], size_id)
    center_loss = huber_loss(
        torch.linalg.vector_norm(targets["center"] - inputs["center"], dim=-1), 2.0)
    center_reg_loss = huber_loss(
        torch.linalg.vector_norm(targets["center"] - inputs["center_reg"], dim=-1), 1.0)

    hrn = _pick(inputs["heading_residuals_normalized"], bin_id)
    hrn_target = targets["heading_residual"] / (math.pi / num_heading_bins)
    heading_residual_loss = huber_loss(hrn - hrn_target, 1.0)

    size_template = size_templates[size_id]  # [b, 3]
    srn = _pick(inputs["size_residuals_normalized"], size_id)  # [b, 3]
    srn_target = targets["size_residual"] / size_template
    size_residual_loss = huber_loss(torch.linalg.vector_norm(srn_target - srn, dim=-1), 1.0)

    heading = _pick(inputs["heading_residuals"], bin_id) + heading_angle_bin_centers[bin_id]
    size = _pick(inputs["size_residuals"], size_id) + size_template
    corners = get_box_corners_3d(inputs["center"], heading, size)
    heading_target = heading_angle_bin_centers[bin_id] + targets["heading_residual"]
    size_target = size_template + targets["size_residual"]
    corners_target, corners_target_flip = get_box_corners_3d(
        targets["center"], heading_target, size_target, with_flip=True)
    corners_loss = huber_loss(torch.minimum(
        torch.linalg.vector_norm(corners - corners_target, dim=1),
        torch.linalg.vector_norm(corners - corners_target_flip, dim=1)), 1.0)

    return mask_loss + box_loss_weight * (
        center_loss + center_reg_loss + heading_loss + size_loss
        + heading_residual_loss_weight * heading_residual_loss
        + size_residual_loss_weight * size_residual_loss
        + corners_loss_weight * corners_loss)
