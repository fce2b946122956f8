"""The port's sample CLI over a PepMerge-style directory on the CPU (a
small model: 2 blocks, narrow widths), its checkpoint flag, and the bench
entry point's one JSON line."""

import csv
import json
import os

import numpy as np
import pytest
import torch
import yaml

from pepflowww_tpu import metrics as jax_metrics
from pepflowww_tpu.data import dataset as jax_dataset

from pepflowww_torch import bench, sample
from pepflowww_torch.data.synthetic import write_structure_dir

torch.set_num_threads(2)

JAX_CSV_COLUMNS = ["id", "sample", "ca_rmsd", "ca_rmsd_aligned", "aar", "tm_score"]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("sample")
    ids = write_structure_dir(str(root / "structs"), sizes=[(4, 14), (9, 30), (3, 50)], seed=5)
    raw = yaml.safe_load(open(os.path.join(os.path.dirname(__file__), "..", "configs",
                                           "learn_angle_tpu.yaml")))
    raw["model"]["encoder"].update(node_embed_size=32, edge_embed_size=16)
    raw["model"]["encoder"]["ipa"].update(c_s=32, c_z=16, c_hidden=16, no_heads=2,
                                          no_qk_points=2, no_v_points=3, seq_tfmr_num_layers=1,
                                          num_blocks=2)
    cfg = root / "small.yaml"
    cfg.write_text(yaml.safe_dump(raw))
    return root, ids, str(cfg)


def _run(setup, out, *extra):
    root, _, cfg = setup
    return sample.main(["--config", cfg, "--structure_dir", str(root / "structs"),
                        "--dataset_dir", str(root / "cache"), "--out", str(root / out),
                        "--num_samples", "3", "--num_steps", "3", "--device", "cpu", *extra])


def _csv(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def test_sample_cli_over_structure_dir(setup):
    root, ids, _ = setup
    res = _run(setup, "out")
    out = root / "out"
    with open(out / "outputs.csv", newline="") as f:
        assert next(csv.reader(f)) == JAX_CSV_COLUMNS
    rows = _csv(out / "outputs.csv")
    assert len(rows) == 9 and [r["id"] for r in rows[::3]] == ids
    assert all(np.isfinite(float(r[k])) for r in rows for k in JAX_CSV_COLUMNS[2:])
    summary = json.load(open(out / "summary.json"))
    want = jax_metrics.summarize_outputs(res["rows"])
    assert sorted(summary["overall"]) == sorted(want["overall"])
    assert json.dumps(summary, sort_keys=True) == json.dumps(json.loads(json.dumps(want)),
                                                             sort_keys=True)
    assert [r["L"] for r in res["runs"]] == [32, 48, 64]
    for cid in ids:
        names = sorted(os.listdir(out / cid))
        assert names == ["sample_0.pdb", "sample_1.pdb", "sample_2.pdb"]
        atoms = [ln for ln in open(out / cid / "sample_0.pdb") if ln.startswith("ATOM")]
        assert atoms and {ln[21] for ln in atoms} == {"A", "B"}
    # the cache the CLI wrote reads in the JAX package
    jds = jax_dataset.PepDataset(str(root / "structs"), str(root / "cache"),
                                 name="pep_pocket_test")
    assert jds.ids == ids


def test_sample_flags_keep_modalities_at_the_data(setup):
    """--sample_seq 0: every generated token is the native one (AAR 1);
    --sample_bb 0: the CA trace is the native one (RMSD 0)."""
    root, ids, _ = setup
    _run(setup, "seq0", "--sample_seq", "0", "--max_complexes", "2")
    rows = _csv(root / "seq0" / "outputs.csv")
    assert len(rows) == 6 and all(float(r["aar"]) == 1.0 for r in rows)
    assert any(float(r["ca_rmsd"]) > 1.0 for r in rows)
    native = [ln for ln in open(root / "structs" / ids[0] / "peptide.pdb") if ln.startswith("ATOM")]
    got = [ln for ln in open(root / "seq0" / ids[0] / "sample_1.pdb")
           if ln.startswith("ATOM") and ln[21] == "A"]
    assert [ln[17:26] for ln in got if ln[12:16] == " CA "] == \
        [ln[17:26] for ln in native if ln[12:16] == " CA "]
    _run(setup, "bb0", "--sample_bb", "0", "--max_complexes", "1")
    rows = _csv(root / "bb0" / "outputs.csv")
    assert len(rows) == 3 and all(float(r["ca_rmsd"]) < 1e-5 for r in rows)


def test_ckpt_loads_a_train_checkpoint(setup):
    from pepflowww_torch import train

    root, _, cfg = setup
    run_dir = train.main(["--config", cfg, "--synthetic", "--debug", "--device", "cpu",
                          "--max_iters", "2", "--val_freq", "2", "--log_freq", "1",
                          "--batch_size", "2", "--logdir", str(root / "logs")])
    ckpt_dir = os.path.join(run_dir, "checkpoints")
    assert os.listdir(ckpt_dir) == ["2.pt"]
    one = ("--max_complexes", "1")
    by_dir = _run(setup, "ck_dir", "--ckpt", ckpt_dir, *one)["rows"]
    by_file = _run(setup, "ck_file", "--torch_ckpt", os.path.join(ckpt_dir, "2.pt"), *one)["rows"]
    seeded = _run(setup, "ck_none", *one)["rows"]
    assert by_dir == by_file
    assert by_dir != seeded


def test_bench_main_prints_one_json_line(monkeypatch, capsys):
    monkeypatch.setattr(bench, "bench_ours", lambda dev=None, reps=3: {
        "pps": 20.0, "sampling_pps": {"L64_B64": 20.0, "L96_B64": 11.0, "L128_B64": 7.0},
        "sampling_pps_plain": 17.5, "train_samples_per_sec": 250.0, "train_step_ms": 128.0,
        "sampler_flops_per_batch": 2.0e13, "train_flops_per_step": 3.0e12,
        "mfu": {"train": 0.02, "sample": 0.006, "peak_tflops_assumed": 989.0},
        "device": {"name": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W"}})
    bench.main([])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    d = json.loads(out[0])
    for key in ("metric", "value", "unit", "vs_baseline", "sampling_pps", "sampling_pps_plain",
                "train_samples_per_sec", "train_step_ms", "sampler_flops_per_batch", "mfu",
                "device"):
        assert key in d, key
    assert d["value"] == 20.0 and d["vs_baseline"] == round(20.0 / 17.5, 3)
    assert set(d["sampling_pps"]) == {"L64_B64", "L96_B64", "L128_B64"}
    assert set(d["mfu"]) == {"train", "sample", "peak_tflops_assumed"}
    assert set(d["device"]) == {"name", "power_limit"}
    assert bench.PEAK_TFLOPS_BY_NAME["NVIDIA H100 80GB HBM3"] == 989.0
