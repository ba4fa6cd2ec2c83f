"""The committed orbax runs through the port's entry points, read by its own
reader: `cli evaluate` of the flagship in a process where orbax,
tensorstore, zstandard and JAX cannot be imported, against `rift_tpu`'s
`evaluate_registration` of the same checkpoint (`tests/test_torch_eval.py`'s
`_hold` rule); `cli evaluate-cls` and `map-sequence --ckpt` on committed
directories at the existing tests' small sizes; the command line's
checkpoint probe; the extractors and the segmentation model the snapshots
build."""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import rift_tpu.train.loop as j_loop
from rift_tpu.train import get_config as j_get_config
from rift_tpu_torch import cli
from rift_tpu_torch.train import get_config, resolve_extractor
from rift_tpu_torch.train.config import ModelConfig
from rift_tpu_torch.train.loop import build_seg_model, load_trained_state
from test_torch_eval import EVAL_SMALL, _hold, _per_pair, _recording

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "checkpoints")
FLAGSHIP_DIR = os.path.join(CKPT, "mn40_sph_pt_r4")
BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "tensorstore", "zstandard", "rift_tpu")
SMALL = [f"evaluate.{k}={v}" for k, v in EVAL_SMALL.items()]

# The port's `cli evaluate` with the meter recording each batch's per-pair
# errors; the results and the errors as one JSON line last.
PORT_EVAL = f"""
import json, sys
for m in {BLOCKED!r}:
    sys.modules[m] = None
import numpy as np
import rift_tpu_torch.train.loop as t_loop
from rift_tpu_torch import cli
batches = []
class Recording(t_loop.MeterRegistration):
    def update(self, errors, reg_time=0.0):
        batches.append({{k: np.asarray(v).tolist() for k, v in errors.items()}})
        super().update(errors, reg_time)
t_loop.MeterRegistration = Recording
code = cli.main(sys.argv[1:])
print(json.dumps({{"code": code, "batches": batches}}))
"""


def _results(out: str) -> dict:
    return {k: float(v) for k, v in (line.split(": ") for line in out.strip().splitlines())}


def test_cli_evaluate_of_the_committed_flagship_without_orbax_matches_reference(monkeypatch):
    """`python -m rift_tpu_torch.cli evaluate --preset mn40_sph_pt_r4 --ckpt
    checkpoints/mn40_sph_pt_r4 --best acc` on the CPU with none of the
    reference's packages importable, at EVAL_SMALL, against `rift_tpu`'s
    evaluate_registration of the same directory: per pair equal `succ`,
    RRE/RTE within the `_hold` tolerances where both recover."""
    argv = ["evaluate", "--preset", "mn40_sph_pt_r4", "--ckpt", FLAGSHIP_DIR, "--best", "acc",
            "--device", "cpu", *SMALL]
    out = subprocess.run([sys.executable, "-c", PORT_EVAL, *argv], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    port = json.loads(lines[-1])
    assert port["code"] == 0
    t_res = _results("\n".join(lines[:-1]))
    got = {k: np.concatenate([np.asarray(b[k]) for b in port["batches"]])
           for k in port["batches"][0]}
    jcfg = j_get_config("mn40_sph_pt")
    for k, v in EVAL_SMALL.items():
        setattr(jcfg.evaluate, k, v)
    want_batches = []
    monkeypatch.setattr(j_loop, "MeterRegistration", _recording(j_loop, want_batches))
    j_res = j_loop.evaluate_registration(jcfg, ckpt_dir=FLAGSHIP_DIR, ckpt_name="best_acc")
    both = _hold(t_res, got, j_res, _per_pair(want_batches), EVAL_SMALL["num_pairs"])
    assert both.all(), (got["rre"], _per_pair(want_batches)["rre"])


def test_cli_evaluate_cls_of_the_committed_classifier(capsys):
    """`evaluate-cls --ckpt checkpoints/mn40_sph_dg_r3 --best acc` on 16
    synthetic test clouds of 128 points: the reference's keys, and the
    trained classifier's accuracy (a seeded one scores ~1/40)."""
    assert cli.main(["evaluate-cls", "--preset", "mn40_sph_dg", "--device", "cpu", "--ckpt",
                     os.path.join(CKPT, "mn40_sph_dg_r3"), "--best", "acc", "--rotations", "2",
                     "dataset.num_points=128",
                     "dataset.synthetic_items={'train': 16, 'valid': 16, 'test': 16}"]) == 0
    results = _results(capsys.readouterr().out)
    assert list(results) == ["acc", "acc_hard", "rot_agree", "logit_drift"]
    assert all(np.isfinite(list(results.values())))
    assert results["acc"] >= 0.5, results


def test_cli_map_sequence_from_the_committed_cube_trunk(capsys):
    """`map-sequence --ckpt checkpoints/rank_mn40_cu_dg --best acc` (the
    trained cube trunk, flips) on 6 scans of 128 points: the reference's
    keys, finite."""
    assert cli.main(["map-sequence", "--preset", "reg_icl_nuim_teaserpp_cu_dg", "--device",
                     "cpu", "--ckpt", os.path.join(CKPT, "rank_mn40_cu_dg"), "--best", "acc",
                     "--loop-stride", "3", "--landmarks-per-edge", "8", "sequence.num_scans=6",
                     "sequence.num_points=128", "sequence.scene_points=4096"]) == 0
    results = _results(capsys.readouterr().out)
    assert list(results)[:3] == ["num_edges", "mean_edge_inliers", "ate_odometry"]
    assert len(results) == 10 and all(np.isfinite(list(results.values())))
    assert results["num_edges"] == 8


def test_cli_probe_accepts_an_orbax_directory(tmp_path, capsys):
    """Without --ckpt, `evaluate` takes train.ckpt_dir's best_acc when it is
    an orbax directory, as the reference's probe does, and still refuses a
    directory that holds no checkpoint."""
    base = ["evaluate", "--preset", "mn40_sph_pt_r4", "--device", "cpu", "--best", "acc",
            "evaluate.num_points=128", "evaluate.num_pairs=2", "evaluate.batch_pairs=2"]
    assert cli.main([*base, f"train.ckpt_dir={FLAGSHIP_DIR}"]) == 0
    assert list(_results(capsys.readouterr().out)) == ["rre", "rte", "rmse", "succ",
                                                       "rmse_succ", "reg_time"]
    with pytest.raises(SystemExit):
        cli.main([*base, f"train.ckpt_dir={tmp_path}"])
    assert "no checkpoint at" in capsys.readouterr().err


@pytest.mark.parametrize("run, preset, lrf_kind, out_channels", [
    ("mn40_sph_pt_r4", "mn40_sph_pt_r4", "pca", 512),
    ("mn40_sph_dg_r2", "mn40_sph_dg", "reference", 512),  # its meta has no lrf_kind
    ("rank_mn40_cu_dg", "reg_icl_nuim_teaserpp_cu_dg", "pca", 512)])
def test_extractor_of_a_committed_classifier(run, preset, lrf_kind, out_channels):
    """The trunk of a committed classifier: the snapshot's architecture
    (ModelConfig's default LRF where the snapshot lacks the field), the
    head dropped before loading, canonical voxels for the evaluation."""
    model = resolve_extractor(get_config(preset), ckpt_dir=os.path.join(CKPT, run),
                              ckpt_name="best_acc", device="cpu")
    assert model.head is None and model.lrf_kind == lrf_kind
    assert model.out_channels == out_channels and model.use_new_coords_for_voxel
    raw, _ = load_trained_state(os.path.join(CKPT, run), "best_acc")
    assert any(k.startswith("head.") for k in raw["model"])


def test_load_trained_state_maps_a_segmentation_tree():
    """shapenet_r3's best_iou goes through weights.from_flax_shapenet into
    the segmentation model its snapshot builds, every key used."""
    raw, snapshot = load_trained_state(os.path.join(CKPT, "shapenet_r3"), "best_iou")
    cfg = get_config("shapenet_seg")
    known = {f.name for f in dataclasses.fields(ModelConfig)}
    cfg.model = ModelConfig(**{k: v for k, v in snapshot["model"].items() if k in known})
    model = build_seg_model(cfg)
    model.load_state_dict(raw["model"], strict=True)
    assert raw["step"] > 0 and "head.Dense_0.weight" in raw["model"]
