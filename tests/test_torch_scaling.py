"""rift_tpu_torch's weak-scaling harness (`parallel/scaling.py`) against
rift_tpu's: the pipeline (normals, the reduced flagship's features from
`from_flax` weights, mutual NN, `ransac+picp`) on 4 pairs of 256 points
against the reference's jitted pipeline on the reference's RANSAC samples,
stage by stage under tests/test_torch_solvers.py's rules; the harness on 4
gloo ranks (torch.multiprocessing.spawn, a deadline that kills hung ranks)
against one process; `WeakScalingResult` against the reference's on given
numbers; the device rule."""
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from rift_tpu.models import PVCNNClassifier as JPVCNNClassifier
from rift_tpu.ops.neighbors import mutual_nearest_neighbors as j_mutual_nn
from rift_tpu.ops.normals import estimate_normals as j_estimate_normals
from rift_tpu.ops.precision import f32_geometry as j_f32
from rift_tpu.parallel.scaling import WeakScalingResult as JWeakScalingResult
from rift_tpu.parallel.scaling import _build_pipeline as j_build_pipeline
from rift_tpu.registration.kabsch import weighted_kabsch as j_kabsch
from rift_tpu_torch.ops.normals import estimate_normals
from rift_tpu_torch.ops.neighbors import mutual_nearest_neighbors
from rift_tpu_torch.parallel import WeakScalingResult, registration_weak_scaling, scaling
from rift_tpu_torch.registration import ransac as ransac_module
from rift_tpu_torch.registration import ransac_from_samples
from rift_tpu_torch.weights import from_flax
from test_torch_solvers import POSE_TOL, _ref_samples, _thin_samples
from test_torch_train import _np

PAIRS, POINTS = 4, 256
# Features of the same weights in another order of sums (XLA's fusions
# against torch's kernels): max abs difference relative to the largest.
FEAT_RTOL = 1e-4
# A pair's pose is determined where NUDGE_TRIES nudges of its targets by
# NUDGE (about 10 ulps) move the port's pose by at most POSE_TOL: with random
# weights the matches are mostly noise, RANSAC's start is arbitrary and
# ICP's nearest neighbours flip from it under rounding (the reference's
# jitted pipeline and its eager per-pair calls part by up to 1.4e-2 on this
# fixture).
NUDGE, NUDGE_TRIES = 1e-6, 2
WORLD = 4
SPAWN_TIMEOUT_S = 90  # 4 ranks import torch and the port, then 3 mesh sizes of 2 calls
RANK_PAIRS, RANK_POINTS = 2, 128


@pytest.fixture(scope="module")
def flagship():
    """The reference's reduced flagship of `registration_weak_scaling`,
    initialized as the reference's harness does, and the port's model on
    the same weights; the harness's first 4 pairs."""
    jm = JPVCNNClassifier(blocks=((16, 1, 8), (32, 1, None)), dim_k=32, is_classify=False,
                          point_kernel_formal="dgcnn_kernel", voxel_shape="spherical",
                          rot_invariant_preprocess="change_coords", with_local_feat="ppf",
                          extra_feature_channels=4, local_neighbors=16)
    src, dst = scaling.weak_scaling_pairs(0, PAIRS, POINTS)
    sample = jnp.concatenate([jnp.asarray(src[:1]), jnp.zeros((1, POINTS, 3))], -1)
    variables = jax.jit(lambda k, x: jm.init(k, x, train=False))(jax.random.PRNGKey(0), sample)
    model = scaling.default_model()
    model.load_state_dict(from_flax(_np(variables["params"]), _np(variables["batch_stats"])))
    return jm, variables, model, src, dst


def _given_samples(monkeypatch):
    """Feed the port's RANSAC the reference's samples of each pair's key
    (the reference's register_pair draws from PRNGKey(0)); the valid masks
    it was called with are kept."""
    calls = []

    def given(valid, k, generator, sample_size=3):
        calls.append(valid.clone())
        keys = [jax.random.PRNGKey(0)] * valid.shape[0]
        return torch.from_numpy(_ref_samples(keys, valid.numpy(), k))

    monkeypatch.setattr(ransac_module, "ransac_samples", given)
    return calls


@jax.jit
@jax.vmap
@j_f32
def _ref_scores(src, dst, valid, samples, threshold=0.08, edge=0.9):
    """The reference's hypothesis scores of each pair on given samples
    (tests/test_torch_solvers.py's `_ref_winner`, jitted over the pairs)."""
    s_pts, d_pts = src[samples], dst[samples]

    def edge_ok(ps, pd):
        es = jnp.linalg.norm(ps[:, None] - ps[None], axis=-1)
        ed = jnp.linalg.norm(pd[:, None] - pd[None], axis=-1)
        ratio = jnp.minimum(es, ed) / jnp.maximum(jnp.maximum(es, ed), 1e-12)
        return jnp.all((ratio > edge) | jnp.eye(3, dtype=bool))

    ok = jax.vmap(edge_ok)(s_pts, d_pts)
    hyp = jax.vmap(j_kabsch)(s_pts, d_pts)
    moved = jnp.einsum("kij,nj->kni", hyp[:, :3, :3], src) + hyp[:, None, :3, 3]
    return jnp.sum((jnp.linalg.norm(moved - dst[None], axis=-1) < threshold) & valid, -1) * ok


def test_pipeline_matches_the_reference_pipeline(flagship, monkeypatch):
    jm, variables, model, src, dst = flagship
    want = np.asarray(jax.jit(j_build_pipeline(jm))(variables, jnp.asarray(src),
                                                    jnp.asarray(dst)))
    calls = _given_samples(monkeypatch)
    pipeline = scaling._build_pipeline(model)
    got = pipeline(torch.from_numpy(src), torch.from_numpy(dst)).numpy()
    assert got.shape == (PAIRS, 4, 4) and np.isfinite(got).all() and len(calls) == 1
    # The features and the mutual-NN matches.
    clouds = np.concatenate([src, dst])
    x = jnp.concatenate([jnp.asarray(clouds), j_estimate_normals(jnp.asarray(clouds))], -1)
    j_feats = np.asarray(jax.jit(lambda v, a: jm.apply(v, a, train=False))(variables, x))
    with torch.no_grad():
        t_clouds = torch.from_numpy(clouds)
        feats = model(torch.cat([t_clouds, estimate_normals(t_clouds)], -1)).numpy()
    assert np.abs(feats - j_feats).max() <= FEAT_RTOL * np.abs(j_feats).max()
    j_i1, j_i2, j_mask = (np.array(a) for a in jax.vmap(j_mutual_nn)(
        jnp.asarray(j_feats[:PAIRS]), jnp.asarray(j_feats[PAIRS:])))
    _, i2, mask = mutual_nearest_neighbors(torch.from_numpy(feats[:PAIRS]),
                                           torch.from_numpy(feats[PAIRS:]))
    np.testing.assert_array_equal(mask.numpy(), j_mask)
    np.testing.assert_array_equal(np.where(j_mask, i2.numpy(), 0), np.where(j_mask, j_i2, 0))
    np.testing.assert_array_equal(calls[0].numpy(), j_mask)
    # RANSAC on those matches and the reference's samples, by the solvers'
    # rules: scores equal but for nearly rank-1 samples, the winner equal
    # wherever no such sample reaches the best score.
    samples = _ref_samples([jax.random.PRNGKey(0)] * PAIRS, j_mask, 256)
    s_src = np.take_along_axis(src, j_i1[..., None], 1)
    s_dst = np.take_along_axis(dst, j_i2[..., None], 1)
    _, _, score = ransac_from_samples(*map(torch.from_numpy, (s_src, s_dst, j_mask, samples)))
    j_scores = np.asarray(_ref_scores(*map(jnp.asarray, (s_src, s_dst, j_mask, samples))))
    same_winner = []
    for i in range(PAIRS):
        scores = j_scores[i]
        winner = int(np.argmax(scores))
        thin = _thin_samples(s_src[i], s_dst[i], samples[i])
        np.testing.assert_array_equal(score[i].numpy()[~thin], scores[~thin])
        if max(score[i].numpy()[thin].max(initial=-1), scores[thin].max(initial=-1)) \
                < scores.max():
            assert int(torch.argmax(score[i])) == winner
        same_winner.append(int(torch.argmax(score[i])) == winner)
    # End to end, where the winner is the same and a nudge of the targets
    # leaves the port's pose in place.
    gen = torch.Generator().manual_seed(3)
    spread = np.zeros(PAIRS)
    for _ in range(NUDGE_TRIES):
        moved = dst + NUDGE * torch.randn(dst.shape, generator=gen).numpy()
        nudged = pipeline(torch.from_numpy(src), torch.from_numpy(moved.astype(np.float32)))
        spread = np.maximum(spread, np.abs(nudged.numpy() - got).max((1, 2)))
    held = (spread <= POSE_TOL) & np.asarray(same_winner)
    assert held.sum() >= 1, (spread, same_winner)
    np.testing.assert_allclose(got[held], want[held], rtol=0, atol=POSE_TOL)


def test_weak_scaling_result_is_the_reference():
    for sizes, tput in (([1, 2, 4], [10.0, 18.0, 30.0]), ([2, 4, 8], [5.0, 9.5, 12.25]),
                        ([], [])):
        got, want = WeakScalingResult(sizes, tput), JWeakScalingResult(sizes, tput)
        assert got.efficiency == want.efficiency
        assert got.as_dict() == want.as_dict()


def test_weak_scaling_defaults_to_the_card_and_runs_one_process_on_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        registration_weak_scaling(mesh_sizes=(1,), pairs_per_device=1, num_points=64)
    res = registration_weak_scaling(mesh_sizes=(1, 2), pairs_per_device=2, num_points=128,
                                    reps=1, device="cpu")
    assert res.mesh_sizes == [1] and res.pairs_per_s[0] > 0 and res.efficiency == [1.0]
    assert res.transforms[1].shape == (2, 4, 4)
    src, dst = scaling.weak_scaling_pairs(0, 2, 128)
    want = scaling._build_pipeline(scaling.default_model())(
        torch.from_numpy(src), torch.from_numpy(dst), scaling.shard_generator("cpu", 0))
    assert torch.equal(res.transforms[1], want)


def _rank_main(rank: int, world: int, workdir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(workdir, 'store')}",
                            rank=rank, world_size=world)
    try:
        res = registration_weak_scaling(mesh_sizes=(1, 2, 4), pairs_per_device=RANK_PAIRS,
                                        num_points=RANK_POINTS, reps=1, device="cpu")
        torch.save({"sizes": res.mesh_sizes, "tput": res.pairs_per_s,
                    "transforms": res.transforms}, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def test_ranks_gather_the_transforms_of_one_process(tmp_path):
    """4 gloo ranks: at mesh size s the ranks below s gather s shards, equal
    bit for bit to one process registering each shard with its own
    generator; the ranks above s take no part; every rank reports rank 0's
    times."""
    ctx = mp.spawn(_rank_main, args=(WORLD, str(tmp_path)), nprocs=WORLD, join=False)
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                pytest.fail(f"the {WORLD} ranks did not finish in {SPAWN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    assert not any(p.is_alive() for p in ctx.processes)
    out = [torch.load(tmp_path / f"rank{r}.pt", weights_only=True) for r in range(WORLD)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as the ranks ran
    try:
        pipeline = scaling._build_pipeline(scaling.default_model())
        shards = []
        for r in range(WORLD):
            src, dst = scaling.weak_scaling_pairs(r * RANK_PAIRS, (r + 1) * RANK_PAIRS,
                                                  RANK_POINTS)
            shards.append(pipeline(torch.from_numpy(src), torch.from_numpy(dst),
                                   scaling.shard_generator("cpu", r * RANK_PAIRS)))
    finally:
        torch.set_num_threads(threads)
    whole = torch.cat(shards)
    for r, o in enumerate(out):
        assert o["sizes"] == [1, 2, 4] and o["tput"] == out[0]["tput"]
        assert sorted(o["transforms"]) == [s for s in (1, 2, 4) if r < s]
        for s, t in o["transforms"].items():
            assert torch.equal(t, whole[:s * RANK_PAIRS]), (r, s)
