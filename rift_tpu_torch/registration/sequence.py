"""Multi-scan mapping, twin of `rift_tpu/registration/sequence.py`:
pairwise registration -> odometry -> pose graph -> bundle adjustment ->
ATE.

T scans and their per-point features become:
1. edges: consecutive (odometry) pairs and loop closures every
   `loop_stride // 2` scans spanning `loop_stride`;
2. pairwise registration of every edge in batches on the device (mutual
   NN or the flip-hypothesis consensus, then the robust solver of
   `method`, composite '+icp'/'+picp'/'+pl' names included), the matches
   refreshed under each edge's final transform;
3. motion-prior-gated re-registration (`gate_rounds`): the matches
   rebuilt inside a spatial gate around the current trajectory, an edge
   taking the new transform where it explains more points;
4. odometry, the chained consecutive measurements;
5. the pose graph over all edges (`registration/pose_graph.py`);
6. bundle adjustment joint with the edges, on landmarks built from the
   refreshed matches and merged across edges by voxel association
   (`registration/bundle_adjust.py`);
7. the ATEs and rotation errors against the ground truth when it is given.

With a torch.distributed `group`, every rank runs the front (the
registration and the landmarks) as one process would, and only the two
solves are sharded: the edges and the landmarks are padded as the
reference pads them and split over the ranks
(`parallel/sharded_ops.py`).

The host steps stay numpy, as in the reference: the odometry chain, the
landmarks and their merge, the inverses of the measurements and the
gate's priors. Node pose T_i is world-from-scan; the pairwise estimate
M_ij maps scan i's points into scan j, so the graph's measurement is
T_i⁻¹ T_j = M_ij⁻¹. RANSAC draws from one generator per edge batch,
seeded with `seed · 1000003 + the batch's first edge`; TEASER, the
preset's method, draws nothing.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..ops.neighbors import (gated_mutual_nearest_neighbors, gather_rows,
                             mutual_nearest_neighbors, pairwise_sqdist)
from ..ops.precision import f32_geometry
from ..ops.se3 import rot_of, rotation_error_deg
from .bundle_adjust import bundle_adjust
from .consensus import consensus_match
from .pipeline import register_pair_from_matches
from .pose_graph import optimize_pose_graph, trajectory_ate

Tensor = torch.Tensor


def build_edges(num_scans: int, loop_stride: int = 6) -> tuple[np.ndarray, np.ndarray]:
    """(i_idx, j_idx) int32: consecutive odometry edges, then loop closures
    every `loop_stride // 2` scans spanning `loop_stride` scans."""
    pairs = [(i, i + 1) for i in range(num_scans - 1)]
    if loop_stride and loop_stride > 1:
        hop = max(loop_stride // 2, 1)
        pairs += [(i, i + loop_stride) for i in range(0, num_scans - loop_stride, hop)]
    i_idx = np.asarray([p[0] for p in pairs], np.int32)
    j_idx = np.asarray([p[1] for p in pairs], np.int32)
    return i_idx, j_idx


@dataclass
class SequenceResult:
    odometry: np.ndarray            # [T, 4, 4]
    graph: np.ndarray               # [T, 4, 4]
    ba: np.ndarray                  # [T, 4, 4]
    edges: tuple[np.ndarray, np.ndarray]
    measurements: np.ndarray        # [E, 4, 4] estimated M_ij
    edge_weights: np.ndarray        # [E] inlier fractions
    metrics: dict = field(default_factory=dict)
    seconds: dict = field(default_factory=dict)  # wall time of each stage
    # The final solves' inputs (numpy): 'graph' (poses, i_idx, j_idx,
    # measurements, weights) and 'ba' (poses, landmarks, obs_pose,
    # obs_local, edge_weights), before any padding or sharding.
    inputs: dict = field(default_factory=dict)


def pad_to_multiple(arrays: list[np.ndarray], multiple: int, pad_values) -> list[np.ndarray]:
    """Each array's leading axis padded with its `pad_values` entry to a
    multiple of `multiple` (the sharded solves' rule)."""
    e = arrays[0].shape[0]
    pad = (-e) % multiple
    if pad == 0:
        return arrays
    out = []
    for arr, val in zip(arrays, pad_values):
        tail = np.broadcast_to(val, (pad,) + arr.shape[1:]).astype(arr.dtype)
        out.append(np.concatenate([arr, tail], 0))
    return out


def _edge_batches(i_idx: np.ndarray, j_idx: np.ndarray, batch_edges: int):
    """(start, n_real, sel_i, sel_j) per batch; the tail padded to
    `batch_edges` with the edge (0, 1)."""
    for start in range(0, len(i_idx), batch_edges):
        sel_i = i_idx[start:start + batch_edges]
        sel_j = j_idx[start:start + batch_edges]
        n_real = len(sel_i)
        if n_real < batch_edges:
            sel_i = np.concatenate([sel_i, np.zeros(batch_edges - n_real, np.int32)])
            sel_j = np.concatenate([sel_j, np.ones(batch_edges - n_real, np.int32)])
        yield start, n_real, sel_i, sel_j


def _pad_transforms(m: np.ndarray, batch_edges: int) -> np.ndarray:
    if m.shape[0] < batch_edges:
        m = np.concatenate([m, np.broadcast_to(np.eye(4, dtype=m.dtype),
                                               (batch_edges - m.shape[0], 4, 4))], 0)
    return m


def _apply(t: Tensor, pts: Tensor) -> Tensor:
    """[b, 4, 4] applied to [b, n, 3] as the reference's s @ R.T + t."""
    return torch.matmul(pts, t[:, :3, :3].transpose(-1, -2)) + t[:, None, :3, 3]


def register_edges(scans: Tensor, features: Tensor, i_idx: np.ndarray, j_idx: np.ndarray,
                   method: str = "teaserpp", noise_bound: float = 0.02,
                   inlier_threshold: float = 0.08, num_hypotheses: int = 512,
                   batch_edges: int = 16, seed: int = 0, flip_features: Tensor | None = None,
                   priors: np.ndarray | None = None, spatial_gate: float | None = None
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Pairwise registration of every edge, `batch_edges` at a time on the
    scans' device.

    scans [T, n, 3], features [T, n, c] ->
      (measurements [E, 4, 4] M_ij, corr_idx2 [E, n] int (the match of
      each source point in the target), corr_w [E, n] confidence weights
      (inlier and matched), edge_weights [E] inlier fractions), numpy.

    `flip_features` [T, 4, n, c] turns on the flip-hypothesis consensus
    per edge. `priors` [E, 4, 4] with `spatial_gate` turns on the
    motion-prior gate: a candidate pair farther than the gate from the
    prior-mapped source point is left out of the mutual-NN argmins.
    """
    use_gate = priors is not None and spatial_gate is not None
    device = scans.device
    meas, idx2s, ws = [], [], []
    with torch.no_grad(), f32_geometry():
        for start, n_real, sel_i, sel_j in _edge_batches(i_idx, j_idx, batch_edges):
            ti = torch.as_tensor(sel_i, device=device).long()
            tj = torch.as_tensor(sel_j, device=device).long()
            s, d = scans[ti], scans[tj]
            sv = None
            if use_gate:
                pr = torch.as_tensor(_pad_transforms(priors[start:start + batch_edges],
                                                     batch_edges), device=device)
                sv = pairwise_sqdist(_apply(pr, s), d) <= spatial_gate * spatial_gate
            if flip_features is not None:
                _, idx2, mask, _ = consensus_match(s, d, flip_features[ti], features[tj],
                                                   tau=2.0 * noise_bound, spatial_valid=sv)
            elif sv is not None:
                _, idx2, mask = gated_mutual_nearest_neighbors(features[ti], features[tj], sv)
            else:
                _, idx2, mask = mutual_nearest_neighbors(features[ti], features[tj])
            idx1 = torch.arange(s.shape[1], device=device).expand(idx2.shape)
            gen = torch.Generator(device=device).manual_seed(seed * 1_000_003 + start)
            t, inl = register_pair_from_matches(
                s, d, idx1, idx2, mask, method=method, noise_bound=noise_bound,
                inlier_threshold=inlier_threshold, num_hypotheses=num_hypotheses,
                generator=gen)
            w = inl.to(s.dtype) * mask.to(s.dtype)
            meas.append(t[:n_real].cpu().numpy())
            idx2s.append(idx2[:n_real].cpu().numpy())
            ws.append(w[:n_real].cpu().numpy())
    measurements = np.concatenate(meas, 0)
    corr_idx2 = np.concatenate(idx2s, 0)
    corr_w = np.concatenate(ws, 0)
    edge_weights = (corr_w > 0.5).mean(-1).astype(np.float32)
    return measurements, corr_idx2, corr_w, edge_weights


def refresh_correspondences(scans: Tensor, i_idx: np.ndarray, j_idx: np.ndarray,
                            measurements: np.ndarray, tau: float, batch_edges: int = 16
                            ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The matches under each edge's final transform: the mutual spatial
    nearest neighbours of the mapped source among the target's points,
    kept where their residual is below `tau`.

    Returns (corr_idx2 [E, n], corr_w [E, n], edge_w [E]), numpy.
    """
    device = scans.device
    idx2s, ws = [], []
    with torch.no_grad(), f32_geometry():
        for start, n_real, sel_i, sel_j in _edge_batches(i_idx, j_idx, batch_edges):
            s = scans[torch.as_tensor(sel_i, device=device).long()]
            d = scans[torch.as_tensor(sel_j, device=device).long()]
            m = torch.as_tensor(_pad_transforms(measurements[start:start + batch_edges],
                                                batch_edges), device=device)
            sp = _apply(m, s)
            _, idx2, mask = mutual_nearest_neighbors(sp, d)
            res = torch.linalg.vector_norm(sp - gather_rows(d, idx2), dim=-1)
            w = (mask & (res < tau)).to(s.dtype)
            idx2s.append(idx2[:n_real].cpu().numpy())
            ws.append(w[:n_real].cpu().numpy())
    corr_idx2 = np.concatenate(idx2s, 0)
    corr_w = np.concatenate(ws, 0)
    edge_w = (corr_w > 0.5).mean(-1).astype(np.float32)
    return corr_idx2, corr_w, edge_w


def odometry_from_measurements(num_scans: int, i_idx: np.ndarray, j_idx: np.ndarray,
                               measurements: np.ndarray) -> np.ndarray:
    """Chain consecutive edges: T_0 = I, T_{i+1} = T_i · M_{i,i+1}⁻¹."""
    cons = {int(a): measurements[e] for e, (a, b) in enumerate(zip(i_idx, j_idx))
            if b == a + 1}
    poses = [np.eye(4, dtype=np.float32)]
    for i in range(num_scans - 1):
        rel = np.linalg.inv(cons[i]) if i in cons else np.eye(4)
        poses.append((poses[-1] @ rel).astype(np.float32))
    return np.stack(poses)


def build_landmarks(scans: np.ndarray, poses: np.ndarray, i_idx: np.ndarray,
                    j_idx: np.ndarray, corr_idx2: np.ndarray, corr_w: np.ndarray,
                    measurements: np.ndarray, per_edge: int = 64,
                    max_residual: float | None = None, min_edge_inliers: float = 0.0
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """BA's input from the matches: each confident match (p in scan i,
    q in scan j) becomes one landmark observed twice, the `per_edge`
    matches of smallest residual under the edge transform first.
    `max_residual` drops matches whose residual exceeds it;
    `min_edge_inliers` drops every landmark of an edge whose inlier
    fraction is below it.

    Returns (landmarks [Nl, 3] world inits, obs_pose [Nl, 2] int32 (−1
    pad), obs_local [Nl, 2, 3]); Nl = E · per_edge.
    """
    lms, obs_pose, obs_local = [], [], []
    for e in range(len(i_idx)):
        i, j = int(i_idx[e]), int(j_idx[e])
        m = measurements[e]
        q_all = scans[j][corr_idx2[e]]
        resid = np.linalg.norm(scans[i] @ m[:3, :3].T + m[:3, 3] - q_all, axis=-1)
        inlier = corr_w[e] > 0.5
        resid = np.where(inlier, resid, np.inf)
        if max_residual is not None:
            resid = np.where(resid <= max_residual, resid, np.inf)
        if inlier.mean() < min_edge_inliers:
            resid = np.full_like(resid, np.inf)
        order = np.argsort(resid, kind="stable")[:per_edge]
        valid = np.isfinite(resid[order])
        p = scans[i][order]                     # [L, 3] scan-i local
        q = q_all[order]                        # [L, 3] scan-j local
        p_w = p @ poses[i][:3, :3].T + poses[i][:3, 3]
        q_w = q @ poses[j][:3, :3].T + poses[j][:3, 3]
        lms.append(np.where(valid[:, None], 0.5 * (p_w + q_w), 0.0))
        op = np.where(valid[:, None], np.array([[i, j]], np.int32),
                      -np.ones((1, 2), np.int32))
        obs_pose.append(op.astype(np.int32))
        obs_local.append(np.stack([p, q], 1))
    return (np.concatenate(lms, 0).astype(np.float32), np.concatenate(obs_pose, 0),
            np.concatenate(obs_local, 0).astype(np.float32))


def merge_landmarks(lms: np.ndarray, obs_pose: np.ndarray, obs_local: np.ndarray,
                    voxel_size: float, k_max: int = 6
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Multi-view association: the 2-view landmarks whose world inits share
    a voxel of `voxel_size` merge into one landmark observed by up to
    `k_max` poses (one observation per pose, the first kept; −1 pads);
    merged landmarks seen by fewer than 2 poses are dropped. Rows with no
    valid observation pass through when there is no valid row at all."""
    valid_row = obs_pose[:, 0] >= 0
    idx_valid = np.where(valid_row)[0]
    if idx_valid.size == 0:
        return lms, obs_pose, obs_local
    keys = np.floor(lms[idx_valid] / max(voxel_size, 1e-9)).astype(np.int64)
    _, inverse = np.unique(keys, axis=0, return_inverse=True)
    inverse = inverse.reshape(-1)
    n_groups = int(inverse.max()) + 1
    out_lm = np.zeros((n_groups, 3), np.float32)
    out_op = -np.ones((n_groups, k_max), np.int32)
    out_ol = np.zeros((n_groups, k_max, 3), np.float32)
    counts = np.zeros(n_groups, np.int64)
    np.add.at(out_lm, inverse, lms[idx_valid])
    np.add.at(counts, inverse, 1)
    out_lm /= np.maximum(counts[:, None], 1)
    fill = np.zeros(n_groups, np.int32)
    for row, g in zip(idx_valid, inverse):
        for s in range(obs_pose.shape[1]):
            p = obs_pose[row, s]
            if p < 0 or fill[g] >= k_max:
                continue
            if p in out_op[g, :fill[g]]:
                continue  # one observation per pose (first wins)
            out_op[g, fill[g]] = p
            out_ol[g, fill[g]] = obs_local[row, s]
            fill[g] += 1
    keep = fill >= 2  # a landmark needs two observing poses to constrain anything
    return out_lm[keep], out_op[keep], out_ol[keep]


def _step_rre(gt: Tensor, poses: Tensor) -> tuple[float, float]:
    """Mean and max gauge-invariant step rotation error (degrees): the
    body-frame relatives R_iᵀR_{i+1} of the estimate against the ground
    truth's, both projected onto SO(3)."""
    rre = rotation_error_deg(
        rot_of(gt[:-1]).transpose(-1, -2) @ rot_of(gt[1:]),
        rot_of(poses[:-1]).transpose(-1, -2) @ rot_of(poses[1:]), orthonormalize=True)
    return float(rre.mean()), float(rre.max())


def map_sequence(scans, features, gt_poses: np.ndarray | None = None,
                 method: str = "teaserpp", noise_bound: float = 0.02,
                 inlier_threshold: float = 0.08, num_hypotheses: int = 512,
                 loop_stride: int = 6, landmarks_per_edge: int = 64,
                 gn_iterations: int = 10, ba_iterations: int = 8,
                 group: dist.ProcessGroup | None = None, batch_edges: int = 16,
                 seed: int = 0, min_edge_inliers: float = 0.05, flip_features=None,
                 edge_anchor: float = 8.0, spatial_gate: float | None | str = "auto",
                 gate_rounds: int = 1, merge_voxel: float | None | str = "auto",
                 device: str | torch.device | None = None) -> SequenceResult:
    """The sequence pipeline on `device` (the card unless it says
    otherwise): scans [T, n, 3] and features [T, n, c] (arrays or tensors;
    `flip_features` [T, 4, n, c] for the consensus) -> SequenceResult.

    `spatial_gate` "auto" is 15 × noise_bound, `merge_voxel` "auto"
    3 × noise_bound. BA's landmarks are gated at 3 × noise_bound residual
    and edges below `min_edge_inliers` give none; BA runs Huber IRLS
    (δ = 1.5 × noise_bound) joint with the edges, each weighted by its
    inlier count times `edge_anchor`, and keeps its result only if the
    cost falls. With `group`, the pose-graph and BA solves are sharded
    over its ranks. `RIFT_MAP_DUMP=path` saves the trajectories and
    measurements as an npz (under `group`, rank 0 alone writes it).
    `seconds` holds each stage's wall time, ended by a synchronize.
    """
    device = resolve_device(device)
    scans_np = np.asarray(scans.cpu() if isinstance(scans, Tensor) else scans, np.float32)
    num_scans = scans_np.shape[0]
    if spatial_gate == "auto":
        spatial_gate = 15.0 * noise_bound
    seconds: dict = {}
    clock = [time.perf_counter()]

    def lap(name: str) -> None:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        now = time.perf_counter()
        seconds[name] = seconds.get(name, 0.0) + now - clock[0]
        clock[0] = now

    i_idx, j_idx = build_edges(num_scans, loop_stride)
    scans_t = torch.as_tensor(scans_np, device=device)
    feats_t = torch.as_tensor(features, device=device)
    flips = torch.as_tensor(flip_features, device=device) if flip_features is not None else None
    reg_kw = dict(method=method, noise_bound=noise_bound, inlier_threshold=inlier_threshold,
                  num_hypotheses=num_hypotheses, batch_edges=batch_edges, flip_features=flips)
    measurements, _, _, _ = register_edges(scans_t, feats_t, i_idx, j_idx, seed=seed, **reg_kw)
    lap("register")
    tau = 3.0 * noise_bound
    corr_idx2, corr_w, edge_w = refresh_correspondences(scans_t, i_idx, j_idx, measurements,
                                                        tau, batch_edges)
    lap("refresh")
    ti, tj = (torch.as_tensor(a, device=device).long() for a in (i_idx, j_idx))

    # Motion-prior-gated re-registration: each edge's matches rebuilt inside
    # a gate around the trajectory so far; an edge keeps whichever transform
    # explains more points.
    for _ in range(gate_rounds if spatial_gate else 0):
        odom0 = odometry_from_measurements(num_scans, i_idx, j_idx, measurements)
        graph0 = optimize_pose_graph(
            torch.as_tensor(odom0, device=device), ti, tj,
            torch.as_tensor(np.linalg.inv(measurements).astype(np.float32), device=device),
            torch.as_tensor(np.maximum(edge_w, 1e-3).astype(np.float32), device=device),
            num_iterations=gn_iterations).cpu().numpy()
        lap("gate pose graph")
        priors = np.einsum("eij,ejk->eik", np.linalg.inv(graph0[j_idx]),
                           graph0[i_idx]).astype(np.float32)
        m2, _, _, _ = register_edges(scans_t, feats_t, i_idx, j_idx, seed=seed + 1,
                                     priors=priors, spatial_gate=spatial_gate, **reg_kw)
        lap("gated register")
        c2, w2, e2 = refresh_correspondences(scans_t, i_idx, j_idx, m2, tau, batch_edges)
        lap("refresh")
        better = e2 > edge_w
        measurements = np.where(better[:, None, None], m2, measurements)
        corr_idx2 = np.where(better[:, None], c2, corr_idx2)
        corr_w = np.where(better[:, None], w2, corr_w)
        edge_w = np.where(better, e2, edge_w)

    odom = odometry_from_measurements(num_scans, i_idx, j_idx, measurements)
    graph_meas = np.linalg.inv(measurements).astype(np.float32)
    weights = np.maximum(edge_w, 1e-3).astype(np.float32)
    world = dist.get_world_size(group) if group is not None else 1
    if group is not None:
        from ..parallel.mesh import shard_batch
        from ..parallel.sharded_ops import bundle_adjust_sharded, optimize_pose_graph_sharded

        shard = pad_to_multiple([i_idx, j_idx, graph_meas, weights], world,
                                [np.int32(0), np.int32(0), np.eye(4, dtype=np.float32),
                                 np.float32(0.0)])
        shard = [torch.as_tensor(a, device=device) for a in shard_batch(shard, group)]
        graph = optimize_pose_graph_sharded(torch.as_tensor(odom, device=device), *shard,
                                            group=group, num_iterations=gn_iterations)
    else:
        graph = optimize_pose_graph(
            torch.as_tensor(odom, device=device), ti, tj,
            torch.as_tensor(graph_meas, device=device),
            torch.as_tensor(weights, device=device), num_iterations=gn_iterations)
    graph = graph.cpu().numpy()
    lap("pose graph")

    # BA joint with the edges: each edge weighs its inlier count times
    # `edge_anchor`, as a robust pairwise measurement sums that many
    # correlated matches.
    huber_delta = 1.5 * noise_bound
    n_pts = scans_np.shape[1]
    edge_info = (np.maximum(edge_w * n_pts, 1.0) * edge_anchor).astype(np.float32)
    edge_terms = (ti, tj, torch.as_tensor(graph_meas, device=device),
                  torch.as_tensor(edge_info, device=device))
    lms, obs_pose, obs_local = build_landmarks(
        scans_np, graph, i_idx, j_idx, corr_idx2, corr_w, measurements,
        per_edge=landmarks_per_edge, max_residual=3.0 * noise_bound,
        min_edge_inliers=min_edge_inliers)
    if merge_voxel == "auto":
        merge_voxel = 3.0 * noise_bound
    if merge_voxel:
        lms, obs_pose, obs_local = merge_landmarks(lms, obs_pose, obs_local, float(merge_voxel))
    lap("landmarks")
    ba_kw = dict(num_iterations=ba_iterations, huber_delta=huber_delta, edges=edge_terms)
    graph_t = torch.as_tensor(graph, device=device)
    if group is not None:
        k_obs = obs_pose.shape[1]
        arrays = pad_to_multiple([lms, obs_pose, obs_local], world,
                                 [np.zeros(3, np.float32), -np.ones(k_obs, np.int32),
                                  np.zeros((k_obs, 3), np.float32)])
        arrays = [torch.as_tensor(a, device=device) for a in shard_batch(arrays, group)]
        ba_poses, _ = bundle_adjust_sharded(graph_t, *arrays, group=group, **ba_kw)
    else:
        ba_poses, _ = bundle_adjust(graph_t, *(torch.as_tensor(a, device=device)
                                               for a in (lms, obs_pose, obs_local)), **ba_kw)
    ba_poses = ba_poses.cpu().numpy()
    lap("bundle adjustment")

    dump = os.environ.get("RIFT_MAP_DUMP")
    if dump and (group is None or dist.get_rank(group) == 0):
        np.savez(dump, measurements=measurements, i_idx=i_idx, j_idx=j_idx, edge_w=edge_w,
                 odom=odom, graph=graph, ba=ba_poses,
                 gt=(gt_poses if gt_poses is not None else np.zeros(0)))
    metrics = {"num_edges": float(len(i_idx)), "mean_edge_inliers": float(edge_w.mean())}
    if gt_poses is not None:
        with torch.no_grad(), f32_geometry():
            gt = torch.as_tensor(gt_poses, device=device)
            odom_t, ba_t = (torch.as_tensor(a, device=device) for a in (odom, ba_poses))
            metrics["ate_odometry"] = float(trajectory_ate(gt, odom_t))
            metrics["ate_graph"] = float(trajectory_ate(gt, graph_t))
            metrics["ate_ba"] = float(trajectory_ate(gt, ba_t))
            metrics["mean_step_rre"], metrics["max_step_rre"] = _step_rre(gt, ba_t)
            metrics["step_rre_odom"], _ = _step_rre(gt, odom_t)
            metrics["step_rre_graph"], _ = _step_rre(gt, graph_t)
            # Edge quality: each estimated M_ij against the ground truth's.
            gt_rel = torch.as_tensor(np.einsum(
                "eij,ejk->eik", np.linalg.inv(gt_poses[j_idx]),
                gt_poses[i_idx]).astype(np.float32), device=device)
            edge_rre = rotation_error_deg(rot_of(gt_rel),
                                          rot_of(torch.as_tensor(measurements, device=device)),
                                          orthonormalize=True)
            metrics["mean_edge_rre"] = float(edge_rre.mean())
    inputs = {"graph": dict(poses=odom, i_idx=i_idx, j_idx=j_idx, measurements=graph_meas,
                            weights=weights),
              "ba": dict(poses=graph, landmarks=lms, obs_pose=obs_pose, obs_local=obs_local,
                         edge_weights=edge_info)}
    return SequenceResult(odometry=odom, graph=graph, ba=ba_poses, edges=(i_idx, j_idx),
                          measurements=measurements, edge_weights=edge_w, metrics=metrics,
                          seconds=seconds, inputs=inputs)
