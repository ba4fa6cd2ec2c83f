"""Pose-graph optimization over multi-scan sequences, twin of
`rift_tpu/registration/pose_graph.py`.

Nodes are scan poses T_i in SE(3), edges relative measurements T_ij; the
solve minimizes Σ_e w_e · ‖Log(T_ij⁻¹ · T_i⁻¹ · T_j)‖² by Gauss-Newton on
right-multiplied twists:
- every edge's residual and its Jacobians at ξ = 0 in one batch, from
  one `torch.func.jacfwd` over both twists under `vmap` (exact
  forward-mode derivatives of the same residual, as the reference takes
  `jax.jacfwd`; one pass over the 12 tangents, the residual as its
  auxiliary output);
- the dense normal system H [6N, 6N] is summed from the edges by one-hot
  products: every block lands in its place by a matmul with fixed
  operands, so the order of the sums does not change from run to run (a
  scatter-add with repeated indices uses float atomics on the card);
- the gauge is fixed by a prior of 1e6 on node 0, and Levenberg damping
  is added; the system is solved by `solve_ex`, which reads no error code
  on the host, in a loop of fixed length: the solve never synchronizes;
- with a `group`, each rank assembles (H, b) from its shard of the edges,
  and the two are all-reduced every iteration before the replicated solve
  (`parallel/sharded_ops.py:optimize_pose_graph_sharded`).
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.func import jacfwd, vmap

from ..ops.precision import f32_geometry
from ..ops.se3 import exp_se3, inverse, log_se3, trans_of

Tensor = torch.Tensor


def _edge_residual(xi_i: Tensor, xi_j: Tensor, pose_i: Tensor, pose_j: Tensor,
                   meas_inv: Tensor) -> Tensor:
    """r = Log(T_ij⁻¹ · (T_i Exp(ξ_i))⁻¹ · (T_j Exp(ξ_j))) ∈ R⁶."""
    t_i = pose_i @ exp_se3(xi_i)
    t_j = pose_j @ exp_se3(xi_j)
    return log_se3(meas_inv @ inverse(t_i) @ t_j)


def _with_value(fn):
    """fn returning (value, value): under jacfwd(has_aux=True) one pass
    gives the Jacobian and the value itself."""
    def both(*args):
        out = fn(*args)
        return out, out
    return both


def _edge_terms(pose_i: Tensor, pose_j: Tensor, meas_inv: Tensor
                ) -> tuple[Tensor, Tensor, Tensor]:
    """Residuals at ξ = 0 and Jacobians with respect to (ξ_i, ξ_j) of E
    edges [E, 4, 4] x3: ([E, 6], [E, 6, 6], [E, 6, 6])."""
    zero = pose_i.new_zeros(pose_i.shape[:-2] + (6,))
    (j_i, j_j), r = vmap(jacfwd(_with_value(_edge_residual), argnums=(0, 1), has_aux=True))(
        zero, zero, pose_i, pose_j, meas_inv)
    return r, j_i, j_j



def one_hot(idx: Tensor, num: int, dtype: torch.dtype) -> Tensor:
    """idx [...] int -> [..., num] rows of the identity (all zeros where
    idx is outside [0, num))."""
    return (idx[..., None] == torch.arange(num, device=idx.device)).to(dtype)


def _assemble(poses: Tensor, i_idx: Tensor, j_idx: Tensor, meas_inv: Tensor,
              weights: Tensor, num_nodes: int) -> tuple[Tensor, Tensor]:
    """Dense normal equations (H [6N, 6N], b [6N]) of all edges, each
    block summed by a one-hot product (a fixed order of the sums)."""
    r, j_i, j_j = _edge_terms(poses[i_idx], poses[j_idx], meas_inv)
    w = weights[:, None, None]
    h_ii = torch.einsum("eki,ekj->eij", j_i, j_i * w)
    h_jj = torch.einsum("eki,ekj->eij", j_j, j_j * w)
    h_ij = torch.einsum("eki,ekj->eij", j_i, j_j * w)
    b_i = torch.einsum("eki,ek->ei", j_i, r * weights[:, None])
    b_j = torch.einsum("eki,ek->ei", j_j, r * weights[:, None])

    n, e = num_nodes, i_idx.shape[0]
    p_i = one_hot(i_idx, n, poses.dtype)  # [E, N]
    p_j = one_hot(j_idx, n, poses.dtype)
    diag = p_i.T @ h_ii.reshape(e, 36) + p_j.T @ h_jj.reshape(e, 36)       # [N, 36]
    off = (p_i.T @ (p_j[:, :, None] * h_ij.reshape(e, 1, 36)).reshape(e, n * 36)
           ).reshape(n, n, 6, 6)                                            # H[i, j] += h_ij
    eye = torch.eye(n, dtype=poses.dtype, device=poses.device)
    h = off + off.permute(1, 0, 3, 2) + eye[:, :, None, None] * diag.reshape(n, 1, 6, 6)
    b = p_i.T @ b_i + p_j.T @ b_j
    return h.permute(0, 2, 1, 3).reshape(6 * n, 6 * n), b.reshape(6 * n)


def gauge_prior(num_nodes: int, dtype: torch.dtype, device) -> Tensor:
    """[6N]: 1e6 on node 0's six coordinates, 0 elsewhere."""
    prior = torch.zeros(6 * num_nodes, dtype=dtype, device=device)
    prior[:6] = 1e6
    return prior


def solve_pose_graph(poses: Tensor, i_idx: Tensor, j_idx: Tensor, measurements: Tensor,
                     weights: Tensor, num_iterations: int, damping: float,
                     group: dist.ProcessGroup | None) -> Tensor:
    """The Gauss-Newton loop of `optimize_pose_graph`; with `group`, (H, b)
    of this rank's edges are all-reduced every iteration."""
    num_nodes = poses.shape[0]
    n6 = 6 * num_nodes
    meas_inv = inverse(measurements)
    prior = gauge_prior(num_nodes, poses.dtype, poses.device)
    eye = torch.eye(n6, dtype=poses.dtype, device=poses.device)
    for _ in range(num_iterations):
        h, b = _assemble(poses, i_idx, j_idx, meas_inv, weights, num_nodes)
        if group is not None:
            dist.all_reduce(h, group=group)
            dist.all_reduce(b, group=group)
        h = h + torch.diag(prior + damping) + damping * eye
        delta = -torch.linalg.solve_ex(h, b)[0].reshape(num_nodes, 6)
        poses = poses @ exp_se3(delta)
    return poses


def optimize_pose_graph(poses: Tensor, i_idx: Tensor, j_idx: Tensor, measurements: Tensor,
                        weights: Tensor | None = None, num_iterations: int = 10,
                        damping: float = 1e-6) -> Tensor:
    """Gauss-Newton pose-graph solve on the tensors' device.

    poses [N, 4, 4] initial; edges (i_idx [E], j_idx [E] int,
    measurements [E, 4, 4] = measured T_i⁻¹ T_j, weights [E], ones when
    None). Returns the optimized poses [N, 4, 4], node 0 gauge-fixed. The
    loop has a fixed length and no host synchronization; two calls on the
    same inputs are bit-equal.
    """
    if weights is None:
        weights = torch.ones(i_idx.shape[0], dtype=poses.dtype, device=poses.device)
    with torch.no_grad(), f32_geometry():
        return solve_pose_graph(poses, i_idx.long(), j_idx.long(), measurements, weights,
                                num_iterations, damping, None)


def trajectory_ate(gt_poses: Tensor, est_poses: Tensor) -> Tensor:
    """Absolute trajectory error: RMSE of the translations after aligning
    the estimate's node 0 with the ground truth's."""
    align = gt_poses[0] @ inverse(est_poses[0])
    est_aligned = torch.matmul(align, est_poses)
    diff = trans_of(gt_poses) - trans_of(est_aligned)
    return torch.sqrt(torch.mean((diff ** 2).sum(-1)))
