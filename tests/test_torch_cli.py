"""rift_tpu_torch's command line against rift_tpu's on the CPU: the preset
table, `apply_overrides` on the same strings, `presets`, `train`,
`evaluate`, `evaluate-cls` and `train-seg` through `cli.main` with
`--device cpu`, `train` under torchrun on 2 gloo ranks (`train-seg` joins
the same group; its data-parallel run is tests/test_torch_dp.py's),
the card by default, the guard against scoring random weights,
`map-sequence` (with `--mesh` on a group of one rank) and
`evaluate --methods`."""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rift_tpu.train.config import apply_overrides as j_apply_overrides
from rift_tpu.train.config import get_config as j_get_config
from rift_tpu.train.config import presets as j_presets
from rift_tpu_torch import cli
from rift_tpu_torch.train import apply_overrides, get_config, presets

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESULT_KEYS = ["rre", "rte", "rmse", "succ", "rmse_succ", "reg_time"]
# tiny_smoke's evaluation cut to 2 pairs of 128 points.
TINY_EVAL = ["evaluate.num_points=128", "evaluate.num_pairs=2"]


def test_preset_table_is_the_reference_s_but_shapenet_seg():
    ours, ref = set(presets()), set(j_presets())
    assert ref - ours == set()  # shapenet_seg too, now that its trainer is ported
    assert ours - ref == {"mn40_sph_pt_r4"}  # the flagship checkpoint's config
    assert {"reg_icl_nuim", "mn40_sph_dg", "mn40_sph_pt"} <= ours


@pytest.mark.parametrize("overrides", [
    ["model.dim_k=256", "train.steps_per_epoch=None"],
    ["evaluate.method='ransac'", "evaluate.pairs_mode=icl_nuim"],  # quoted, and a bare string
    ["model.blocks=((16, 1, 8), (32, 1, None))", "--evaluate.num_pairs=4"],
    ["dataset.synthetic_items={'train': 8, 'valid': 4, 'test': 4}", "seed=3",
     "evaluate.noise_bound=5e-2", "model.rot_invariant_preprocess=None"],
    ["sequence.num_scans=7", "sequence.path=scans.h5", "train.reg_probe_interval=1"],
])
def test_apply_overrides_matches_reference(overrides):
    ours = apply_overrides(get_config("reg_icl_nuim"), overrides)
    ref = j_apply_overrides(j_get_config("reg_icl_nuim"), overrides)
    ref_dict = json.loads(json.dumps(dataclasses.asdict(ref)))
    ours_dict = json.loads(json.dumps(dataclasses.asdict(ours)))
    ref_dict["train"].pop("log_every")  # the field the port leaves out
    assert ours_dict == ref_dict
    assert ours_dict != json.loads(json.dumps(dataclasses.asdict(get_config("reg_icl_nuim"))))


@pytest.mark.parametrize("bad, error", [
    ("model.no_such_field=1", AttributeError),
    ("sequence.nope=2", AttributeError),
    ("model.dim_k", ValueError),
])
def test_apply_overrides_refuses_like_reference(bad, error):
    with pytest.raises(error):
        apply_overrides(get_config("reg_noise"), [bad])
    with pytest.raises(error):
        j_apply_overrides(j_get_config("reg_noise"), [bad])


def test_presets_prints_the_sorted_names(capsys):
    assert cli.main(["presets"]) == 0
    assert capsys.readouterr().out.split() == sorted(presets())


def _results(out: str) -> dict:
    lines = [line.split(": ") for line in out.strip().splitlines()]
    return {k: float(v) for k, v in lines}


def test_train_then_evaluate_through_the_cli(tmp_path, capsys):
    """`train` of tiny_smoke with overrides writes its checkpoints; then
    `evaluate --ckpt` (common), `--best acc` and the train.ckpt_dir
    checkpoint found without --ckpt print the six result lines."""
    ckpt = str(tmp_path / "run")
    train_args = ["--device", "cpu", f"train.ckpt_dir={ckpt}", "optim.num_epochs=1",
                  "train.steps_per_epoch=2"]
    assert cli.main(["train", "--preset", "tiny_smoke", "--no-resume", *train_args]) == 0
    assert {"common.pt", "best_acc.pt"} <= set(os.listdir(ckpt))
    capsys.readouterr()
    runs = (["--ckpt", ckpt], ["--ckpt", ckpt, "--best", "acc"], [f"train.ckpt_dir={ckpt}"])
    for args in runs:
        assert cli.main(["evaluate", "--preset", "tiny_smoke", "--device", "cpu", *args,
                         *TINY_EVAL]) == 0
        results = _results(capsys.readouterr().out)
        assert list(results) == RESULT_KEYS and all(np.isfinite(list(results.values())))


def test_evaluate_without_a_checkpoint_exits_and_names_the_probe(tmp_path, capsys):
    empty = str(tmp_path / "empty")
    with pytest.raises(SystemExit) as exc:
        cli.main(["evaluate", "--preset", "tiny_smoke", "--device", "cpu",
                  f"train.ckpt_dir={empty}", *TINY_EVAL])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert os.path.join(empty, "common.pt") in err and "--untrained" in err
    with pytest.raises(SystemExit):
        cli.main(["evaluate", "--preset", "tiny_smoke", "--best", "rre", "--device", "cpu",
                  f"train.ckpt_dir={empty}"])
    assert os.path.join(empty, "best_rre.pt") in capsys.readouterr().err


def test_evaluate_untrained_reg_icl_nuim_on_the_cpu(capsys):
    """The preset the README's CPU drive runs: seeded weights, narrow
    blocks, 4 adjacent-scan pairs of 256 points, ransac+picp."""
    assert cli.main(["evaluate", "--preset", "reg_icl_nuim", "--device", "cpu", "--untrained",
                     "model.blocks=((16, 1, 8), (32, 1, 8), (32, 1, None))",
                     "model.local_neighbors=16", "evaluate.num_points=256",
                     "evaluate.num_pairs=4", "evaluate.num_hypotheses=500"]) == 0
    results = _results(capsys.readouterr().out)
    assert list(results) == RESULT_KEYS and all(np.isfinite(list(results.values())))


def test_the_cli_takes_the_card_by_default(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    parser = cli.build_parser()
    assert parser.parse_args(["train"]).device == "cuda"
    assert parser.parse_args(["train"]).preset == "mn40_sph_dg"
    assert parser.parse_args(["evaluate"]).preset == "reg_noise_teaserpp_cu_dg"
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["train", "--preset", "tiny_smoke", f"train.ckpt_dir={tmp_path}"])
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["evaluate", "--preset", "tiny_smoke", "--untrained", *TINY_EVAL])


# The reference's map-sequence result keys, in its order
# (rift_tpu/registration/sequence.py:map_sequence with ground truth).
MAP_KEYS = ["num_edges", "mean_edge_inliers", "ate_odometry", "ate_graph", "ate_ba",
            "mean_step_rre", "max_step_rre", "step_rre_odom", "step_rre_graph", "mean_edge_rre"]
# tiny_smoke's trunk as a feature extractor (seeded weights) on a 6-scan
# sequence of 128 points.
TINY_MAP = ["--preset", "tiny_smoke", "--device", "cpu", "model.is_classify=False",
            "sequence.num_scans=6", "sequence.num_points=128", "sequence.scene_points=4096"]


def test_map_sequence_prints_the_reference_keys(capsys):
    """`map-sequence` runs the whole pipeline (flip features, registration,
    the gated round, pose graph, BA) and prints the reference's metric
    keys; the parser's defaults are the reference's."""
    assert cli.main(["map-sequence", *TINY_MAP, "--loop-stride", "3",
                     "--landmarks-per-edge", "8"]) == 0
    results = _results(capsys.readouterr().out)
    assert list(results) == MAP_KEYS and all(np.isfinite(list(results.values())))
    assert results["num_edges"] == 5 + 3  # 5 consecutive edges; loops (0, 3), (1, 4), (2, 5)
    args = cli.build_parser().parse_args(["map-sequence"])
    assert (args.preset, args.loop_stride, args.landmarks_per_edge, args.mesh, args.device) == (
        "reg_icl_nuim_teaserpp_cu_dg", 6, 64, False, "cuda")


def test_map_sequence_mesh_runs_on_a_one_rank_group(capsys):
    """Without a launcher, `--mesh` shards the solves over a gloo group of
    this process alone: the same metrics as without it (bit for bit on
    one rank), and no group is left behind."""
    import torch.distributed as dist

    assert cli.main(["map-sequence", *TINY_MAP, "--mesh"]) == 0
    mesh = _results(capsys.readouterr().out)
    assert not dist.is_initialized()
    assert cli.main(["map-sequence", *TINY_MAP]) == 0
    assert _results(capsys.readouterr().out) == mesh


def test_evaluate_methods_prints_one_result_a_method(capsys):
    """`evaluate --methods ransac,fgr,teaserpp+icp --untrained` prints the
    six result keys of each method, prefixed with its name ('+' as '_')."""
    assert cli.main(["evaluate", "--preset", "tiny_smoke", "--device", "cpu", "--untrained",
                     "--methods", "ransac,fgr,teaserpp+icp", "model.is_classify=False",
                     "evaluate.num_hypotheses=64", *TINY_EVAL]) == 0
    results = _results(capsys.readouterr().out)
    assert list(results) == [f"{m}_{k}" for m in ("ransac", "fgr", "teaserpp_icp")
                             for k in RESULT_KEYS]
    assert all(np.isfinite(list(results.values())))


def test_the_cli_runs_as_a_module():
    out = subprocess.run([sys.executable, "-m", "rift_tpu_torch.cli", "presets"], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "reg_icl_nuim" in out.stdout.split()


CLS_KEYS = ["acc", "acc_hard", *[f"sweep_acc_l{i}" for i in range(6)], "sweep_auc",
            "rot_agree", "logit_drift"]


def test_evaluate_cls_prints_the_reference_keys(tmp_path, capsys):
    """`evaluate-cls` on the checkpoint `train` wrote: the reference's result
    keys in its order (rift_tpu/cli.py prints the same dict), `--no-hard`,
    `--rotations 0` and `--best`; a `dataset.*` override beats the
    checkpoint's snapshot, and other overrides leave the scores alone."""
    ckpt = str(tmp_path / "run")
    assert cli.main(["train", "--preset", "tiny_smoke", "--device", "cpu", "--no-resume",
                     f"train.ckpt_dir={ckpt}", "optim.num_epochs=1",
                     "train.steps_per_epoch=2"]) == 0
    capsys.readouterr()
    base = ["evaluate-cls", "--preset", "tiny_smoke", "--device", "cpu", "--ckpt", ckpt]
    assert cli.main([*base, "--rotations", "2", "--sweep"]) == 0
    full = _results(capsys.readouterr().out)
    assert list(full) == CLS_KEYS and all(np.isfinite(list(full.values())))
    assert cli.main([*base, "--no-hard", "--rotations", "0", "--best", "acc"]) == 0
    assert list(_results(capsys.readouterr().out)) == ["acc"]
    assert cli.main([*base, "--no-hard", "--rotations", "2", "model.dim_k=7"]) == 0
    same = _results(capsys.readouterr().out)
    assert same == {k: full[k] for k in ("acc", "rot_agree", "logit_drift")}
    assert cli.main([*base, "--no-hard", "--rotations", "2", "dataset.num_points=32"]) == 0
    assert _results(capsys.readouterr().out)["logit_drift"] != full["logit_drift"]


def test_train_under_torchrun_is_data_parallel(tmp_path):
    """`torchrun --nproc_per_node=2 -m rift_tpu_torch.cli train --device cpu`
    joins a gloo group of 2 ranks and trains data-parallel: one metric log
    (rank 0's), its checkpoints, and the epoch's loss of the global batches
    within 1e-5 of the single-process run's."""
    def run(ckpt, launcher):
        args = ["train", "--preset", "tiny_smoke", "--device", "cpu", "--no-resume",
                f"train.ckpt_dir={ckpt}", "optim.num_epochs=1", "train.steps_per_epoch=2",
                "dataset.num_workers=0"]
        out = subprocess.run([sys.executable, *launcher, "-m", "rift_tpu_torch.cli", *args],
                             cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1"),
                             capture_output=True, text=True, timeout=180)
        assert out.returncode == 0, out.stderr[-3000:]
        with open(os.path.join(ckpt, "tiny_smoke.metrics.jsonl")) as f:
            return out.stderr, [json.loads(line) for line in f]

    log, dp = run(str(tmp_path / "dp"), ["-m", "torch.distributed.run", "--standalone",
                                         "--nproc_per_node=2"])
    assert "data-parallel over 2 ranks (gloo)" in log
    _, single = run(str(tmp_path / "single"), [])
    assert [r["split"] for r in dp] == [r["split"] for r in single] == ["train", "valid"]
    assert dp[0]["loss"] == pytest.approx(single[0]["loss"], rel=1e-5, abs=0)
    assert {"common.pt", "best_acc.pt"} <= set(os.listdir(tmp_path / "dp"))


def test_shapenet_seg_preset_equals_the_reference():
    ours = json.loads(json.dumps(dataclasses.asdict(get_config("shapenet_seg"))))
    ref = json.loads(json.dumps(dataclasses.asdict(j_get_config("shapenet_seg"))))
    assert ref["train"].pop("log_every") == 10  # the field the port leaves out
    assert ours == ref
    m = ours["model"]
    assert (m["num_classes"], m["with_se"], ours["dataset"]["num_points"],
            ours["train"]["batch_size"]) == (50, False, 2048, 8)


# train-seg of tiny_smoke on the synthetic ShapeNet split at 64 points,
# one epoch of 2 steps.
TINY_SEG = ["--preset", "tiny_smoke", "--device", "cpu", "dataset.num_points=64",
            "optim.num_epochs=1", "train.steps_per_epoch=2"]


def test_train_seg_through_the_cli(tmp_path, capsys, monkeypatch):
    """`train-seg` writes best_iou and common and the epoch's loss and
    mIoU; run again it resumes from common and trains no further; without
    --device it takes the card."""
    ckpt = str(tmp_path / "seg")
    assert cli.main(["train-seg", *TINY_SEG, f"train.ckpt_dir={ckpt}"]) == 0
    assert {"best_iou.pt", "common.pt", "common.meta.json"} <= set(os.listdir(ckpt))
    with open(os.path.join(ckpt, "tiny_smoke.metrics.jsonl")) as f:
        log = [json.loads(line) for line in f]
    assert len(log) == 1 and log[0]["step"] == 2
    assert np.isfinite(log[0]["loss"]) and 0.0 <= log[0]["iou"] <= 1.0
    assert cli.main(["train-seg", *TINY_SEG, f"train.ckpt_dir={ckpt}"]) == 0
    with open(os.path.join(ckpt, "tiny_smoke.metrics.jsonl")) as f:
        assert len(f.readlines()) == 1
    assert cli.build_parser().parse_args(["train-seg"]).preset == "shapenet_seg"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["train-seg", "--preset", "tiny_smoke", f"train.ckpt_dir={tmp_path / 'card'}"])
