"""The validation battery on the port against the reference's scripts, on
the CPU: scripts/validate_flagship_torch.py's steps are
scripts/validate_flagship.py's with the port's command line and its
device option; its summary has the reference's table rows; every failed
attempt of a step is recorded; the committed flagship's sweep through
both packages on the battery's pair modes; and
scripts/map_drift_torch.py's drift curve against scripts/map_drift.py's on
a cut sequence of the same trained trunk."""
import importlib.util
import json
import os
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rift_tpu.train as j_train
import rift_tpu.train.loop as j_loop
import rift_tpu_torch.registration.pipeline as pipeline
import rift_tpu_torch.registration.ransac as ransac_module
import rift_tpu_torch.train.loop as t_loop
from rift_tpu.data.registration_pairs import get_pairs as j_get_pairs
from rift_tpu.ops.normals import estimate_normals as j_normals
from rift_tpu.registration.icp import icp_plane_pose as j_icp_plane
from rift_tpu.registration.icp import icp_pose as j_icp
from rift_tpu.registration.metrics import pair_errors as j_pair_errors
from rift_tpu.train import get_config as j_get_config
from rift_tpu_torch.data import get_pairs as t_get_pairs
from rift_tpu_torch.ops.precision import f32_geometry
from rift_tpu_torch.registration import icp_pose, pair_errors
from rift_tpu_torch.train import get_config
from test_torch_data import PICP_RRE_BOUND, PICP_RTE_BOUND
from test_torch_eval import RECOVERED, _hold, _per_pair, _recording
from test_torch_sequence import MAP_TOL
from test_torch_solvers import POSE_TOL, _ref_samples

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP_DIR = os.path.join(ROOT, "checkpoints", "mn40_sph_pt_r4")
# The dense refiners' end results, per pair where both packages recover
# the pose: on the objects within REFINE_RRE_TOL degrees and REFINE_RTE_TOL;
# on the room scans of icl_nuim by ROADMAP §3's rule for the point-to-plane
# step, which is no contraction along the floor and walls (tests/
# test_torch_data.py's PICP_*_BOUND). On the objects the point-to-plane
# step is no contraction either: a 1e-6 nudge of its start moves the
# reference's own end result by up to 0.51 degrees RRE and 6.2e-3 RTE on
# the sweep's recovered clean and partial pairs, while the two packages
# part by at most 0.145 degrees and 4.5e-3 end to end, 0.096 and 4.1e-3
# from the same start (point-to-point ICP within 1.2e-7 there). A refiner
# that returned its start would part by 2.2-4.8 degrees.
REFINE_RRE_TOL, REFINE_RTE_TOL = 0.5, 1e-2
ROOM_RRE_TOL, ROOM_RTE_TOL = PICP_RRE_BOUND, PICP_RTE_BOUND
SWEEP_METHODS = ["teaserpp", "teaserpp+picp", "ransac+picp", "ransac+pl"]
# A pair of each mode at tests/test_torch_eval.py's EVAL_SMALL points, in
# one batch of one sweep: the reference's sweep costs its compiles a call.
SWEEP_MODES, SWEEP_POINTS = ("clean", "partial", "partial0.5", "icl_nuim"), 256
# The drift curve on a cut sequence: DRIFT_SCANS scans of 256 points of a
# room sampled from 512 (the cube map test's reason, tests/
# test_torch_cube_ckpt.py), loop closures every DRIFT_STRIDE scans.
DRIFT_SCANS, DRIFT_STRIDE = 6, 4
# A step's rotation error compares two poses, each held within MAP_TOL a
# matrix entry by the map tests: their relative rotations differ by at most
# 2·MAP_TOL an entry, 6·MAP_TOL in Frobenius norm, an angle of
# 6/√2·MAP_TOL radians.
STEP_RRE_TOL = float(np.degrees(6.0 / np.sqrt(2.0) * MAP_TOL))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """torch on one thread: the suite runs 6 workers on the host's cores,
    and the solvers' thousands of small ops a call stall on a contended
    thread pool (a 1.5 s test took 95 s under the suite's load)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _load(name):
    path = os.path.join(ROOT, "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def scripts():
    return SimpleNamespace(ref=_load("validate_flagship"), port=_load("validate_flagship_torch"),
                           drift_ref=_load("map_drift"), drift_port=_load("map_drift_torch"))


def _steps(module, monkeypatch, tmp_path, run):
    """The (tag, argv) of every step `run()` launches through `module`,
    each step answered as a success; files written under tmp_path."""
    steps = []

    def fake(tag, argv, timeout, retries=1, on_failure=None):
        steps.append((tag, argv))
        return {"tag": tag, "ok": True, "metrics": {}, "sec": 0.0}

    monkeypatch.setattr(module, "run_step", fake)
    monkeypatch.setattr(module, "REPO", str(tmp_path))
    assert run() == 0
    return steps


def _as_port(argv):
    """A reference step's argv as the port runs it: the port's command
    line, and the device option after the subcommand instead of
    `--platform` before it."""
    argv = list(argv)
    i = argv.index("rift_tpu.cli")
    argv[i] = "rift_tpu_torch.cli"
    device = []
    if argv[i + 1] == "--platform":
        device = ["--device", argv[i + 2]]
        del argv[i + 1:i + 3]
    return argv[:i + 2] + device + argv[i + 2:]


@pytest.mark.parametrize("device, data", [("cpu", False), (None, False), ("cpu", True)])
def test_steps_are_the_references_with_the_ports_cli(scripts, monkeypatch, tmp_path, device,
                                                     data):
    """Every step's argv (cls, the 7 modes, the latency probe, the map),
    with and without a device and with a data root holding two of the h5
    files and the ModelNet40 tree, equals the reference's."""
    args = ["--ckpt", "checkpoints/mn40_sph_pt_r4", "--name", "best_acc"]
    if data:
        root = tmp_path / "data"
        (root / "modelnet40_normal_resampled").mkdir(parents=True)
        (root / "test").mkdir()
        (root / "modelnet_clean.h5").write_bytes(b"")
        (root / "test" / "icl_nuim_test.h5").write_bytes(b"")
        args += ["--data-root", str(root)]
    ref_args = args + (["--platform", device] if device else [])
    port_args = args + (["--device", device] if device else [])
    monkeypatch.setattr(sys, "argv", ["validate_flagship.py", *ref_args])
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    want = _steps(scripts.ref, monkeypatch, tmp_path / "ref", scripts.ref.main)
    got = _steps(scripts.port, monkeypatch, tmp_path / "port",
                 lambda: scripts.port.main(port_args))
    assert [t for t, _ in got] == [t for t, _ in want] == (
        ["cls"] + [f"reg_{m}" for m in scripts.ref.REG_MODES] + ["reg_latency", "map"])
    for (tag, g), (_, w) in zip(got, want):
        assert g == _as_port(w), tag
    assert scripts.port.REG_MODES == scripts.ref.REG_MODES
    assert scripts.port.REG_METHODS == scripts.ref.REG_METHODS
    assert sorted(os.listdir(tmp_path / "port")) == ["VALIDATION_torch_r01.jsonl",
                                                    "VALIDATION_torch_r01.md"]


def _records(rng):
    """A battery's jsonl records: every step, one mode failed."""
    slugs = [m.replace("+", "_") for m in ("teaserpp", "ransac", "fgr", "teaserpp+picp",
                                           "ransac+picp", "ransac+pl")]
    keys = ("rre", "rte", "rmse", "succ", "rmse_succ", "reg_time")
    recs = [{"tag": "cls", "ok": True, "sec": 1.0, "metrics": dict(zip(
        ("acc", "acc_hard", "rot_agree", "logit_drift"), rng.rand(4).tolist()))}]
    for mode in ("clean", "noise", "partial", "partial0.7", "partial0.5", "partial0.3",
                 "icl_nuim"):
        ok = mode != "partial0.3"
        recs.append({"tag": f"reg_{mode}", "ok": ok, "sec": 1.0, "metrics": {
            f"{s}_{k}": float(rng.rand() * 10) for s in slugs for k in keys} if ok else {}})
    recs.append({"tag": "reg_latency", "ok": True, "sec": 1.0,
                 "metrics": {f"ransac_picp_{k}": float(rng.rand()) for k in keys}})
    recs.append({"tag": "map", "ok": True, "sec": 1.0, "metrics": {k: float(rng.rand()) for k in (
        "num_edges", "mean_edge_inliers", "ate_odometry", "ate_graph", "ate_ba",
        "mean_step_rre", "max_step_rre", "step_rre_odom", "step_rre_graph", "mean_edge_rre")}})
    return recs


def _rows(path):
    with open(path) as f:
        return [line for line in f.read().splitlines()
                if line.startswith("|") or line.startswith("mean edge inliers")]


def test_summary_has_the_references_table_rows(scripts, monkeypatch, tmp_path, rng):
    """write_summary of the same records: the registration table (a failed
    mode's rows marked FAILED), the map's table and its edge line equal
    the reference's; the header names the card; the reference's prose of
    TPU measurements is not there."""
    recs = _records(rng)
    monkeypatch.setattr(scripts.ref, "REPO", str(tmp_path))
    monkeypatch.setattr(scripts.port, "REPO", str(tmp_path))
    scripts.ref.write_summary(recs, "checkpoints/mn40_sph_pt_r4", 5)
    path = scripts.port.write_summary(recs, "checkpoints/mn40_sph_pt_r4", 5,
                                      card="NVIDIA H100 80GB HBM3, 700.00 W")
    want = _rows(tmp_path / "VALIDATION_r05.md")
    got = _rows(path)
    assert got == want and len(got) == 2 + 42 + 2 + 3 + 1
    assert sum("FAILED" in r for r in got) == 6
    with open(path) as f:
        text = f.read()
    assert "Device: NVIDIA H100 80GB HBM3, 700.00 W." in text
    assert "TPU" not in text and "Hypothesis-budget" not in text


def test_every_failed_attempt_is_printed_and_recorded(scripts, monkeypatch, tmp_path, capsys):
    """run_step retries a failing step once, printing each attempt and
    handing it to on_failure; a success gives the `key: value` lines as
    metrics; main exits 1 when a step failed and its jsonl holds the
    attempts beside the results."""
    attempts = []
    fail = [sys.executable, "-c", "import sys; print('boom'); sys.exit(3)"]
    res = scripts.port.run_step("cls", fail, 60.0, on_failure=attempts.append)
    assert res == {"tag": "cls", "ok": False, "metrics": {}, "sec": res["sec"]}
    assert [(a["attempt"], a["error"], a["ok"]) for a in attempts] == [(0, "rc=3", False),
                                                                       (1, "rc=3", False)]
    assert "boom" in attempts[0]["tail"] and capsys.readouterr().out.count("rc=3") == 2
    ok = scripts.port.run_step("map", [sys.executable, "-c", "print('ate_ba: 1.5e-3')"], 60.0)
    assert ok["ok"] and ok["metrics"] == {"ate_ba": 1.5e-3}

    monkeypatch.setattr(scripts.port, "REPO", str(tmp_path))
    real = scripts.port.run_step

    def flaky(tag, argv, timeout, retries=1, on_failure=None):
        argv = fail if tag == "map" else [sys.executable, "-c", "print('acc: 1.0')"]
        return real(tag, argv, timeout, retries, on_failure)

    monkeypatch.setattr(scripts.port, "run_step", flaky)
    assert scripts.port.main(["--ckpt", "x", "--device", "cpu", "--steps", "cls,map"]) == 1
    with open(tmp_path / "VALIDATION_torch_r01.jsonl") as f:
        lines = [json.loads(line) for line in f]
    assert [(r["tag"], r["ok"], r.get("attempt")) for r in lines] == [
        ("cls", True, None), ("map", False, 0), ("map", False, 1), ("map", False, None)]


class _Mixed:
    """The pairs of several modes in one set, each mode's from its
    package's own get_pairs: one sweep call holds them all."""

    def __init__(self, get_pairs, num_points, modes, per_mode):
        self.items = [pairs[i] for m in modes
                      for pairs in [get_pairs(None, num_points, m, per_mode)]
                      for i in range(per_mode)]

    def __len__(self):
        return len(self.items)

    def batches(self, batch_size=1):
        for start in range(0, len(self.items), batch_size):
            chunk = self.items[start:start + batch_size]
            yield SimpleNamespace(**{k: np.stack([it[j] for it in chunk])
                                     for j, k in enumerate(("source", "target", "transform"))})


@pytest.fixture(scope="module")
def flagship():
    """The committed flagship's trunk in both packages (the port reads the
    orbax directory itself, the reference through orbax)."""
    cfg = get_config("reg_noise_teaserpp_cu_dg")
    model = t_loop.resolve_extractor(cfg, None, FLAGSHIP_DIR, "best_acc", "cpu")
    state, jax_model = j_loop.resolve_extractor(j_get_config("reg_noise_teaserpp_cu_dg"), None,
                                                None, FLAGSHIP_DIR, "best_acc",
                                                j_loop.get_logger("validate"))
    return model, state, jax_model


@pytest.fixture(scope="module")
def sweep(flagship):
    """Both packages' sweep of SWEEP_METHODS on a pair of each of
    SWEEP_MODES, in one batch of one call of the battery's object-mode
    preset (reg_clean_teaserpp_cu_dg: noise bound 0.02, 1000 hypotheses):
    the port's flip features computed once (its warm-up batch is the
    timed one), RANSAC on the reference's own samples of the batch's keys. Gives the results and
    per-pair errors of each, the pairs, and each refined method's start
    and end pose in the port {method: (start, end)} of the timed batch."""
    model, state, jax_model = flagship
    preset, num = "reg_clean_teaserpp_cu_dg", len(SWEEP_MODES)
    cfg, jcfg = get_config(preset), j_get_config(preset)
    for c in (cfg, jcfg):
        c.evaluate.num_points, c.evaluate.num_pairs, c.evaluate.batch_pairs = \
            SWEEP_POINTS, num, num
    pairs = _Mixed(t_get_pairs, SWEEP_POINTS, SWEEP_MODES, 1)
    _, sub = jax.random.split(jax.random.PRNGKey(cfg.seed))
    keys = jax.random.split(sub, num)  # the one batch's keys, the warm-up's too
    calls, got, want, refined, method, feats = [], [], [], {}, [], []

    def given(valid, k, generator, sample_size=3):
        calls.append(k)
        return torch.from_numpy(_ref_samples(keys, valid.numpy(), k))

    flips, solve, refine = t_loop.flip_features, t_loop.solve_eval_batch, pipeline.refine_pose

    def flips_once(model, x, b):
        if not feats:
            feats[:] = [x, flips(model, x, b)]
        assert torch.equal(x, feats[0])
        return feats[1]

    def solve_recorded(src, dst, matches, evaluate, m=None, generator=None):
        method[:] = [m]
        return solve(src, dst, matches, evaluate, m, generator)

    def refine_recorded(pts1, pts2, transform, refiner, noise_bound=pipeline.NOISE_BOUND):
        out = refine(pts1, pts2, transform, refiner, noise_bound)
        if refiner is not None:
            refined[method[0]] = (transform, out)
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_loop, "get_pairs", lambda path, n, mode, count: pairs)
        mp.setattr(j_loop, "get_pairs", lambda path, n, mode, count: _Mixed(
            j_get_pairs, n, SWEEP_MODES, 1))
        mp.setattr(ransac_module, "ransac_samples", given)
        mp.setattr(t_loop, "flip_features", flips_once)
        mp.setattr(t_loop, "solve_eval_batch", solve_recorded)
        mp.setattr(pipeline, "refine_pose", refine_recorded)
        mp.setattr(t_loop, "MeterRegistration", _recording(t_loop, got))
        mp.setattr(j_loop, "MeterRegistration", _recording(j_loop, want))
        t_res = t_loop.evaluate_registration_sweep(cfg, SWEEP_METHODS, model=model, device="cpu")
        j_res = j_loop.evaluate_registration_sweep(jcfg, SWEEP_METHODS, state=state,
                                                   model=jax_model)
    assert calls == [cfg.evaluate.num_hypotheses] * 4  # 2 RANSAC methods, warm-up and batch
    batch = next(pairs.batches(num))
    return SimpleNamespace(
        t_res=t_res, j_res=j_res, num=num, noise_bound=cfg.evaluate.noise_bound,
        src=torch.from_numpy(batch.source), dst=torch.from_numpy(batch.target),
        gt=torch.from_numpy(batch.transform), refined=refined,
        got={m: _per_pair(got[i::len(SWEEP_METHODS)]) for i, m in enumerate(SWEEP_METHODS)},
        want={m: _per_pair(want[i::len(SWEEP_METHODS)]) for i, m in enumerate(SWEEP_METHODS)})


def _refine_tol():
    """Per pair of SWEEP_MODES: (RRE degrees, RTE) of the refined end
    results, REFINE_* on the objects, the point-to-plane rule on the room."""
    room = np.array([m == "icl_nuim" for m in SWEEP_MODES])
    return (np.where(room, ROOM_RRE_TOL, REFINE_RRE_TOL),
            np.where(room, ROOM_RTE_TOL, REFINE_RTE_TOL))


def _hold_refined(got, want):
    """Per pair where both recover (RRE under RECOVERED degrees), the end
    results within _refine_tol; returns where both recover."""
    rre_tol, rte_tol = _refine_tol()
    both = (got["rre"] < RECOVERED) & (want["rre"] < RECOVERED)
    np.testing.assert_array_less(np.abs(got["rre"] - want["rre"])[both], rre_tol[both])
    np.testing.assert_array_less(np.abs(got["rte"] - want["rte"])[both], rte_tol[both])
    return both


def test_flagship_sweep_on_the_battery_modes_matches_reference(sweep):
    """The committed flagship through both packages' sweep (the sweep
    fixture) of teaserpp, teaserpp+picp, ransac+picp and ransac+pl on a
    pair of 256 points of each of clean, partial, partial0.5 and
    icl_nuim. teaserpp by tests/test_torch_eval.py's _hold; the refined
    methods by their end results where both recover (_hold_refined), and
    a refiner that returned its start pose fails that hold; the trained
    trunk recovers pairs with every refined method (partial0.5 fails with
    every method, as in the reference's battery)."""
    _hold(sweep.t_res["teaserpp"], sweep.got["teaserpp"], sweep.j_res["teaserpp"],
          sweep.want["teaserpp"], sweep.num)
    assert list(sweep.t_res) == SWEEP_METHODS
    for m in SWEEP_METHODS[1:]:
        assert all(np.isfinite(v) for v in sweep.t_res[m].values()), m
        assert _hold_refined(sweep.got[m], sweep.want[m]).any(), m
        start = {k: v.numpy() for k, v in pair_errors(sweep.src, sweep.gt,
                                                      sweep.refined[m][0]).items()}
        with pytest.raises(AssertionError):  # a refiner that does nothing
            _hold_refined(start, sweep.want[m])


def _ref_refine(src, dst, start, refiner, noise_bound):
    """The reference's refiner `refiner` from `start` [b, 4, 4], per pair:
    (the point-to-point stage of '+picp' or None, the end pose)."""
    s, d, init = (jnp.asarray(a.numpy()) for a in (src, dst, start))
    icp = None
    if refiner == "+picp":
        icp = jax.vmap(lambda a, c, t: j_icp(a, c, init_transform=t))(s, d, init)
        init, gate = icp, 0.05
    else:
        gate = 3.0 * noise_bound
    end = jax.vmap(lambda a, c, n, t: j_icp_plane(
        a, c, n, init_transform=t, max_correspondence_distance=gate))(s, d, j_normals(d), init)
    return icp, end


@pytest.mark.parametrize("method", SWEEP_METHODS[1:])
def test_refiners_from_the_ports_start_match_reference(sweep, method):
    """Each refined method's refiner in the reference from the port's own
    start pose in the sweep (teaserpp's, held by _hold, or RANSAC's on the
    reference's samples), on the same pairs: '+picp''s point-to-point stage
    within POSE_TOL (ROADMAP §3's rule for it); the end results by
    _hold_refined."""
    start, end = sweep.refined[method]
    refiner = method[method.index("+"):]
    w_icp, w_end = _ref_refine(sweep.src, sweep.dst, start, refiner, sweep.noise_bound)
    if w_icp is not None:
        with torch.no_grad(), f32_geometry():
            t_icp = icp_pose(sweep.src, sweep.dst, init_transform=start)
        np.testing.assert_allclose(t_icp.numpy(), np.asarray(w_icp), rtol=0, atol=POSE_TOL)
    got = {k: v.numpy() for k, v in pair_errors(sweep.src, sweep.gt, end).items()}
    want = {k: np.asarray(v) for k, v in j_pair_errors(
        jnp.asarray(sweep.src.numpy()), jnp.asarray(sweep.gt.numpy()), w_end).items()}
    assert _hold_refined(got, want).any()


def test_map_drift_curve_matches_reference(scripts, monkeypatch, tmp_path):
    """map_drift_torch.drift against map_drift.py's main on DRIFT_SCANS
    scans of 256 points over two orbits, loop stride DRIFT_STRIDE, both
    maps from the committed flagship trunk's flip features (the port's,
    handed to the reference too: the trunk's features are held against
    the reference's in tests/test_torch_eval.py, and its feature
    program's compile would double this test's cost): the same edges and
    method; every ATE of the curve and of the metrics, the BA gain and the
    mean edge inliers within tests/test_torch_sequence.py's MAP_TOL; the
    rotation metrics (degrees) within STEP_RRE_TOL."""
    def cut(config):
        config.sequence.num_points, config.sequence.scene_points = 256, 512
        return config

    flips = []
    t_extract = t_loop.extract_features_flips
    monkeypatch.setattr(t_loop, "extract_features_flips",
                        lambda model, clouds: flips.append(t_extract(model, clouds)) or flips[-1])
    got = scripts.drift_port.drift(FLAGSHIP_DIR, "best_acc", DRIFT_SCANS, DRIFT_STRIDE, "cpu",
                                   config=cut(get_config(scripts.drift_port.PRESET)))
    j_get = j_train.get_config
    monkeypatch.setattr(j_train, "get_config", lambda name: cut(j_get(name)))
    monkeypatch.setattr(j_loop, "extract_features_flips",
                        lambda state, model, clouds: flips[0].numpy())
    out = tmp_path / "drift.json"
    monkeypatch.setattr(sys, "argv", ["map_drift.py", "--ckpt", FLAGSHIP_DIR, "--scans",
                                      str(DRIFT_SCANS), "--loop-stride", str(DRIFT_STRIDE),
                                      "--out", str(out)])
    assert scripts.drift_ref.main() == 0
    with open(out) as f:
        want = json.load(f)
    assert set(want) - set(got) == {"ba_analysis"}
    for key in ("scans", "loop_stride", "edges", "method"):
        assert got[key] == want[key], key
    assert [c["T"] for c in got["drift_curve"]] == [c["T"] for c in want["drift_curve"]]
    for g, w in zip(got["drift_curve"], want["drift_curve"]):
        for key in ("ate_odometry", "ate_graph", "ate_ba"):
            assert abs(g[key] - w[key]) <= MAP_TOL, (g["T"], key)
    assert abs(got["ba_vs_graph_final"] - want["ba_vs_graph_final"]) <= MAP_TOL
    assert list(got["metrics"]) == list(want["metrics"])
    for key, value in got["metrics"].items():
        tol = STEP_RRE_TOL if "rre" in key else MAP_TOL
        assert abs(value - want["metrics"][key]) <= tol, key
    assert got["metrics"]["ate_ba"] < 0.05  # the trained trunk maps the room
