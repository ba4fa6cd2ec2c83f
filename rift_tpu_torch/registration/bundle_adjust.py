"""Bundle adjustment over poses and landmarks with the Schur complement,
twin of `rift_tpu/registration/bundle_adjust.py`.

Scan poses T_i map scan-local coordinates to the world (X_w = T_i · y);
landmark l is observed in scan i at local coordinates y_il, with the
residual r_il = T_i⁻¹ X_l − y_il. Observations are stored landmark-major
with a fixed fan-out K (obs_pose [Nl, K], −1 padding; obs_local
[Nl, K, 3]).

- Per-observation Jacobians come from one `torch.func.jacfwd` over the
  twist and the landmark under `vmap`.
- H_ll is 3 × 3 block-diagonal and inverted in closed form; the Schur
  complement S = H_pp − Σ_l W_l H_ll⁻¹ W_lᵀ is summed as dense products:
  each landmark's W blocks are placed at their poses by a one-hot product
  into [Nl, Np, 6, 3], and S's correction is one matmul over the
  landmarks. The order of every sum is fixed (no float atomics), so two
  calls on the same inputs are bit-equal on the card.
- Huber IRLS, the joint pose-graph edge system (`edges`) and the
  accept-only-if-the-cost-improves guard as in the reference; the loop
  has a fixed length, the solve is `solve_ex` and the guard a
  `torch.where`: nothing synchronizes with the host.
- With a `group`, each rank holds its shard of the landmarks: (S, b) and
  the guard's landmark costs are all-reduced, the edge system is added
  once after the reduction, and landmarks are back-substituted locally
  (`parallel/sharded_ops.py:bundle_adjust_sharded`).
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.func import jacfwd, vmap

from ..ops.precision import f32_geometry
from ..ops.se3 import exp_se3, inverse, rot_of, trans_of
from .pose_graph import _assemble, _edge_residual, _with_value, gauge_prior, one_hot

Tensor = torch.Tensor


def _obs_residual(xi: Tensor, x_l: Tensor, pose: Tensor, y_obs: Tensor) -> Tensor:
    """r = (T Exp(ξ))⁻¹ · X_l − y_obs ∈ R³."""
    t_inv = inverse(pose @ exp_se3(xi))
    return torch.matmul(rot_of(t_inv), x_l[..., None])[..., 0] + trans_of(t_inv) - y_obs


def _obs_terms(pose: Tensor, x_l: Tensor, y_obs: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """Residuals and Jacobians (pose [M, 3, 6], landmark [M, 3, 3]) of M
    observations at ξ = 0: pose [M, 4, 4], x_l and y_obs [M, 3]."""
    zero = pose.new_zeros(pose.shape[:-2] + (6,))
    (j_pose, j_lm), r = vmap(jacfwd(_with_value(_obs_residual), argnums=(0, 1),
                                    has_aux=True))(zero, x_l, pose, y_obs)
    return r, j_pose, j_lm


def _inv3(m: Tensor) -> Tensor:
    """Batched closed-form 3 × 3 inverse (adjugate / det, |det| floored at
    1e-12)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co = torch.stack([
        torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], -1),
        torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], -1),
        torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], -1),
    ], -2)
    det = a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)
    return (co / torch.clamp(det.abs(), min=1e-12)[..., None, None]
            * torch.sign(det)[..., None, None])


def _landmark_terms(poses: Tensor, landmarks: Tensor, obs_pose: Tensor, obs_local: Tensor,
                    damping: float, huber_delta: float | None = None):
    """Per-landmark pieces of the Schur system: (valid, r, H_ll⁻¹ [Nl, 3, 3],
    W [Nl, K, 6, 3], b_p [Nl, K, 6], b_l [Nl, 3], H_pp blocks
    [Nl, K, 6, 6]). With `huber_delta`, each observation is weighted by
    the Huber influence min(1, δ/‖r‖) at the current iterate (its square
    root scales r and both Jacobians)."""
    nl, k = obs_pose.shape
    valid = obs_pose >= 0
    safe_pose = torch.clamp(obs_pose, min=0)
    pose_per_obs = poses[safe_pose].reshape(nl * k, 4, 4)
    lm_per_obs = landmarks[:, None, :].expand(nl, k, 3).reshape(nl * k, 3)
    r, j_p, j_l = _obs_terms(pose_per_obs, lm_per_obs, obs_local.reshape(nl * k, 3))
    r, j_p, j_l = r.reshape(nl, k, 3), j_p.reshape(nl, k, 3, 6), j_l.reshape(nl, k, 3, 3)
    m = valid[..., None, None]
    r = torch.where(valid[..., None], r, torch.zeros_like(r))
    j_p = torch.where(m, j_p, torch.zeros_like(j_p))
    j_l = torch.where(m, j_l, torch.zeros_like(j_l))
    if huber_delta is not None:
        rn = torch.linalg.vector_norm(r, dim=-1)
        sw = torch.sqrt(torch.clamp(huber_delta / torch.clamp(rn, min=1e-12), max=1.0))
        r = r * sw[..., None]
        j_p = j_p * sw[..., None, None]
        j_l = j_l * sw[..., None, None]
    eye3 = torch.eye(3, dtype=poses.dtype, device=poses.device)
    h_ll = torch.einsum("nkri,nkrj->nij", j_l, j_l) + damping * eye3
    a_inv = _inv3(h_ll)
    w = torch.einsum("nkri,nkrj->nkij", j_p, j_l)           # [Nl, K, 6, 3]
    b_p = torch.einsum("nkri,nkr->nki", j_p, r)             # [Nl, K, 6]
    b_l = torch.einsum("nkri,nkr->ni", j_l, r)              # [Nl, 3]
    h_pp_diag = torch.einsum("nkri,nkrj->nkij", j_p, j_p)   # [Nl, K, 6, 6]
    return valid, r, a_inv, w, b_p, b_l, h_pp_diag


def _assemble_schur(poses: Tensor, landmarks: Tensor, obs_pose: Tensor, obs_local: Tensor,
                    damping: float, huber_delta: float | None = None):
    """The Schur system of a landmark shard, flat: (S [6Np, 6Np], b [6Np],
    the back-substitution's pieces). Every block reaches its pose by a
    one-hot product."""
    num_poses = poses.shape[0]
    valid, r, a_inv, w, b_p, b_l, h_pp_diag = _landmark_terms(
        poses, landmarks, obs_pose, obs_local, damping, huber_delta)
    safe_pose = torch.clamp(obs_pose, min=0)
    nl, k = obs_pose.shape
    onehot = one_hot(safe_pose, num_poses, poses.dtype)                 # [Nl, K, Np]
    flat = onehot.reshape(nl * k, num_poses).T                          # [Np, Nl·K]
    diag = (flat @ h_pp_diag.reshape(nl * k, 36)).reshape(num_poses, 6, 6)
    b = flat @ b_p.reshape(nl * k, 6)                                   # [Np, 6]
    wa = torch.einsum("nkij,njl->nkil", w, a_inv)                       # [Nl, K, 6, 3]
    # Σ_k over a landmark's observations of each pose: W and W·A⁻¹ placed
    # at their poses, [Nl, Np, 6, 3]; the correction Σ_l (W A⁻¹)_l W_lᵀ is
    # then one matmul over (l, m).
    wa_pose = torch.einsum("nka,nkim->naim", onehot, wa)
    w_pose = torch.einsum("nka,nkim->naim", onehot, w)
    corr = torch.einsum("naim,nbjm->aibj", wa_pose, w_pose).reshape(6 * num_poses,
                                                                    6 * num_poses)
    b = b - torch.einsum("naim,nm->ai", wa_pose, b_l)
    eye = torch.eye(num_poses, dtype=poses.dtype, device=poses.device)
    s = (eye[:, None, :, None] * diag[:, :, None, :]).reshape(
        6 * num_poses, 6 * num_poses) - corr
    return s, b.reshape(6 * num_poses), (a_inv, w, b_l, safe_pose)


def _solve_poses(s: Tensor, b: Tensor, num_poses: int, damping: float,
                 extra: tuple[Tensor, Tensor] | None = None) -> Tensor:
    """The reduced pose step [Np, 6]: S (+ the edge system `extra`), the
    gauge prior on pose 0 and damping, solved by `solve_ex`."""
    n6 = 6 * num_poses
    if extra is not None:  # the pose-graph edge system (joint BA)
        s = s + extra[0]
        b = b + extra[1]
    eye = torch.eye(n6, dtype=s.dtype, device=s.device)
    h = s + torch.diag(gauge_prior(num_poses, s.dtype, s.device)) + damping * eye
    return -torch.linalg.solve_ex(h, b)[0].reshape(num_poses, 6)


def _edge_system(poses: Tensor, edges) -> tuple[Tensor, Tensor]:
    """The pose-graph edge normal equations at the current iterate (flat
    [6N, 6N], [6N]), `pose_graph._assemble`."""
    i_idx, j_idx, rel_meas, w_e = edges
    return _assemble(poses, i_idx, j_idx, inverse(rel_meas), w_e, poses.shape[0])


def _edge_cost(poses: Tensor, edges) -> Tensor:
    """0.5 Σ_e w_e ‖r_e‖² at the current poses."""
    i_idx, j_idx, rel_meas, w_e = edges
    zero = poses.new_zeros((i_idx.shape[0], 6))
    r = _edge_residual(zero, zero, poses[i_idx], poses[j_idx], inverse(rel_meas))
    return 0.5 * (w_e * (r ** 2).sum(-1)).sum()


def _back_substitute(delta_p: Tensor, aux) -> Tensor:
    a_inv, w, b_l, safe_pose = aux
    dp = delta_p[safe_pose]                                             # [Nl, K, 6]
    rhs = b_l + torch.einsum("nkij,nki->nj", w, dp)
    return -torch.einsum("nij,nj->ni", a_inv, rhs)


def _robust_cost(poses: Tensor, landmarks: Tensor, obs_pose: Tensor, obs_local: Tensor,
                 huber_delta: float | None) -> Tensor:
    """Mean Huber cost over the valid observations (the guard's monitor)."""
    valid = obs_pose >= 0
    nl, k = obs_pose.shape
    pose = poses[torch.clamp(obs_pose, min=0)]
    r = _obs_residual(poses.new_zeros((nl, k, 6)), landmarks[:, None, :].expand(nl, k, 3),
                      pose, obs_local)
    rn = torch.linalg.vector_norm(torch.where(valid[..., None], r, torch.zeros_like(r)), dim=-1)
    d = huber_delta if huber_delta is not None else 1e9
    cost = torch.where(rn <= d, 0.5 * rn ** 2, d * (rn - 0.5 * d))
    cost = torch.where(valid, cost, torch.zeros_like(cost))
    return cost.sum() / torch.clamp(valid.sum(), min=1)


def _landmark_cost_sum(poses, landmarks, obs_pose, obs_local, huber_delta, group):
    """The landmarks' robust cost times their valid count, summed over the
    ranks of `group`."""
    n_obs = torch.clamp((obs_pose >= 0).sum(), min=1)
    c = _robust_cost(poses, landmarks, obs_pose, obs_local, huber_delta) * n_obs
    if group is not None:
        dist.all_reduce(c, group=group)
    return c


def solve_bundle(poses: Tensor, landmarks: Tensor, obs_pose: Tensor, obs_local: Tensor,
                 num_iterations: int, damping: float, huber_delta: float | None,
                 edges, group: dist.ProcessGroup | None) -> tuple[Tensor, Tensor]:
    """The loop and guard of `bundle_adjust`; with `group`, (S, b) and the
    landmark costs of this rank's landmarks are all-reduced."""
    num_poses = poses.shape[0]
    new_poses, new_lms = poses, landmarks
    for _ in range(num_iterations):
        s, b, aux = _assemble_schur(new_poses, new_lms, obs_pose, obs_local, damping,
                                    huber_delta)
        if group is not None:
            dist.all_reduce(s, group=group)
            dist.all_reduce(b, group=group)
        extra = _edge_system(new_poses, edges) if edges is not None else None
        delta_p = _solve_poses(s, b, num_poses, damping, extra)
        delta_l = _back_substitute(delta_p, aux)
        new_poses, new_lms = new_poses @ exp_se3(delta_p), new_lms + delta_l

    def total_cost(p, lm):
        c = _landmark_cost_sum(p, lm, obs_pose, obs_local, huber_delta, group)
        if edges is not None:
            c = c + _edge_cost(p, edges)
        return c

    keep = total_cost(new_poses, new_lms) < total_cost(poses, landmarks)
    return torch.where(keep, new_poses, poses), torch.where(keep, new_lms, landmarks)


def _edge_tensors(edges, device):
    if edges is None:
        return None
    i_idx, j_idx, rel_meas, w_e = edges
    return (i_idx.to(device).long(), j_idx.to(device).long(), rel_meas.to(device),
            w_e.to(device))


def bundle_adjust(poses: Tensor, landmarks: Tensor, obs_pose: Tensor, obs_local: Tensor,
                  num_iterations: int = 10, damping: float = 1e-4,
                  huber_delta: float | None = 0.05,
                  edges: tuple[Tensor, Tensor, Tensor, Tensor] | None = None
                  ) -> tuple[Tensor, Tensor]:
    """Joint pose and landmark refinement on the tensors' device.

    poses [Np, 4, 4], landmarks [Nl, 3], obs_pose [Nl, K] int (−1 pad),
    obs_local [Nl, K, 3] -> (poses, landmarks) optimized, pose 0 fixed.
    `huber_delta` turns on the Huber IRLS weights (None: least squares).
    `edges` = (i_idx [E], j_idx [E], rel_meas [E, 4, 4] measured
    T_i⁻¹ T_j, w_e [E]) makes the solve joint with the pose graph: the
    edge normal equations join the Schur system every iteration, and the
    guard compares the joint cost. The result is the input unless the
    total cost falls.
    """
    with torch.no_grad(), f32_geometry():
        return solve_bundle(poses, landmarks, obs_pose.long(), obs_local, num_iterations,
                            damping, huber_delta, _edge_tensors(edges, poses.device), None)
