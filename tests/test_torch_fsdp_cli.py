"""The port's train CLI with ``--fsdp`` and ``--tp`` over CPU processes
(gloo), each a fresh interpreter that imports only the port.

* Two ``--multihost --fsdp`` processes at ``--batch_size 2`` log the
  per-iteration losses of one process at ``--batch_size 4`` within the JAX
  test's rtol 5e-3 (``tests/test_multihost.py:147``).
* Their checkpoint holds the single process's layout (the reference-named
  model state dict, torch Adam's per-parameter moments) and resumes strict
  in one process; the single process's checkpoint resumes under ``--fsdp``
  at two ranks, which log the loss one process logs when it resumes it
  (``tests/test_multihost.py:231``).
* ``--tp 2`` over two spawned ranks logs the losses of one process (the
  plain profile), and ``--tp 3`` on two ranks exits.
* ``--dp_manual`` with ``--fsdp`` or ``--tp`` exits with the JAX CLI's
  message.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from pepflowww_torch.convert import load_state_dict
from pepflowww_torch.data.dataset import PepDataset
from pepflowww_torch.data.synthetic import write_structure_dir
from pepflowww_torch.models.flow import FlowModel
from pepflowww_torch.parallel import dist
from pepflowww_torch.train import DP_MANUAL_GRID
from pepflowww_torch.train import main as train_main

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300
TINY_YAML = """\
model:
  encoder:
    node_embed_size: 32
    edge_embed_size: 16
    ipa:
      c_s: 32
      c_z: 16
      c_hidden: 8
      no_heads: 2
      no_qk_points: 2
      no_v_points: 3
      seq_tfmr_num_heads: 2
      seq_tfmr_num_layers: 1
      num_blocks: 2
train:
  seed: 7
  batch_size: 4
  val_freq: 1000
"""
LOSS_RE = re.compile(r"\] it (\d+) \| loss ([-\d.na]+)")


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    return {**env, "OMP_NUM_THREADS": "1", **extra}


def _popen(argv, **env):
    return subprocess.Popen([sys.executable, "-m", "pepflowww_torch.train", "--device", "cpu",
                             *argv], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, env=_env(**env))


def _finish(procs):
    outs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n=====\n".join(o[-3000:] for o in outs)
    return outs


def _losses(text):
    return {int(m.group(1)): float(m.group(2)) for m in LOSS_RE.finditer(text)}


def _metric_losses(logdir):
    (run,) = os.listdir(logdir)
    with open(os.path.join(logdir, run, "metrics.jsonl")) as f:
        return {r["step"]: r["loss"] for r in map(json.loads, f) if r["tag"] == "train"}


def _ranks(n, argv):
    port = dist.free_port()
    return [_popen(argv + ["--multihost", "--coordinator_address", f"127.0.0.1:{port}",
                           "--num_processes", str(n), "--process_id", str(i)]) for i in range(n)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A 24-complex directory and its cache; one process at B=4 and two
    --fsdp ranks at B=2, 3 iterations, a checkpoint every 2."""
    root = tmp_path_factory.mktemp("fsdp_cli")
    sdir, ddir, cfg = str(root / "structs"), str(root / "cache"), str(root / "tiny.yaml")
    write_structure_dir(sdir, n=24, seed=0, min_rec=20, max_rec=40)
    assert len(PepDataset(sdir, ddir, name="mh", n_jobs=1)) == 24   # cache built once, here
    with open(cfg, "w") as f:
        f.write(TINY_YAML)
    common = ["--config", cfg, "--structure_dir", sdir, "--dataset_dir", ddir, "--dataset_name",
              "mh", "--log_freq", "1", "--val_freq", "2"]
    outs = _finish([_popen(common + ["--max_iters", "3", "--batch_size", "4", "--logdir",
                                     str(root / "single")])]
                   + _ranks(2, common + ["--max_iters", "3", "--batch_size", "2", "--logdir",
                                         str(root / "fsdp"), "--fsdp"]))
    return {"root": root, "common": common, "cfg": cfg, "single": outs[0], "ranks": outs[1:]}


def _ckpt(logdir, it):
    (run,) = os.listdir(logdir)
    return os.path.join(logdir, run, "checkpoints", f"{it}.pt")


def test_two_fsdp_ranks_follow_the_single_process(runs):
    assert "grid: 2 data x 1 model ranks | fsdp: True | tp: off" in runs["ranks"][0]
    assert _losses(runs["ranks"][1]) == {}   # rank 1 logs nothing
    single = _metric_losses(runs["root"] / "single")
    multi = _metric_losses(runs["root"] / "fsdp")
    assert set(single) == set(multi) == {1, 2, 3}
    gap = max(abs(multi[i] / single[i] - 1) for i in single)
    print(f"two --fsdp ranks x B=2 against one process x B=4: losses {multi} vs {single}, "
          f"largest relative gap {gap:.2e}")
    for it in single:
        np.testing.assert_allclose(multi[it], single[it], rtol=5e-3, err_msg=f"iteration {it}")


def test_fsdp_checkpoint_is_the_single_layout_and_resumes_strict(runs):
    """The two ranks' checkpoint 2 against the single process's: the same
    keys and shapes, optimizer state per parameter with the same steps;
    one process resumes from it at iteration 3."""
    mine = torch.load(_ckpt(runs["root"] / "fsdp", 2), map_location="cpu", weights_only=False)
    ref = torch.load(_ckpt(runs["root"] / "single", 2), map_location="cpu", weights_only=False)
    assert {k: v.shape for k, v in mine["model"].items()} == \
        {k: v.shape for k, v in ref["model"].items()}
    from pepflowww_torch.config import load_train_config

    load_state_dict(FlowModel(load_train_config(runs["cfg"])[0]), mine["model"])
    mo, ro = mine["optimizer"]["optimizer"], ref["optimizer"]["optimizer"]
    assert mo["param_groups"][0]["params"] == ro["param_groups"][0]["params"]
    assert {k: v for k, v in mo["param_groups"][0].items() if k != "params"} == \
        {k: v for k, v in ro["param_groups"][0].items() if k != "params"}
    assert sorted(mo["state"]) == sorted(ro["state"])
    for i, st in ro["state"].items():
        assert float(mo["state"][i]["step"]) == float(st["step"]) == 2.0
        for k in ("exp_avg", "exp_avg_sq"):
            assert mo["state"][i][k].shape == st[k].shape, (i, k)
    out = _finish([_popen(runs["common"] + ["--max_iters", "4", "--batch_size", "4", "--logdir",
                                            str(runs["root"] / "resume1"), "--resume",
                                            _ckpt(runs["root"] / "fsdp", 2)])])[0]
    assert "at iteration 3" in out and set(_losses(out)) == {3, 4}, out[-3000:]


def test_single_checkpoint_resumes_under_fsdp(runs):
    """Two --fsdp ranks and one process resume the single process's
    checkpoint 2 (the loader and the noise start again on a resume): their
    iteration 3 agrees within rtol 5e-3."""
    ckpt = _ckpt(runs["root"] / "single", 2)
    outs = _finish(_ranks(2, runs["common"] + [
        "--max_iters", "3", "--batch_size", "2", "--logdir", str(runs["root"] / "resume2"),
        "--fsdp", "--resume", ckpt]) + [_popen(runs["common"] + [
            "--max_iters", "3", "--batch_size", "4", "--logdir", str(runs["root"] / "resume3"),
            "--resume", ckpt])])
    assert "at iteration 3" in outs[0] and "at iteration 3" in outs[2]
    got = _metric_losses(runs["root"] / "resume2")
    want = _metric_losses(runs["root"] / "resume3")
    assert set(got) == set(want) == {3}
    np.testing.assert_allclose(got[3], want[3], rtol=5e-3)


def test_tp_two_spawned_ranks_follow_the_single_process(runs, monkeypatch, tmp_path):
    """``--tp 2`` where two devices are counted: two spawned ranks, one
    model group, whose losses are one process's (the plain profile)."""
    monkeypatch.setattr(dist, "local_world", lambda device=None: 2)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    synth = ["--config", runs["cfg"], "--synthetic", "--device", "cpu", "--batch_size", "2",
             "--max_iters", "2", "--log_freq", "1"]
    run = train_main(synth + ["--tp", "2", "--logdir", str(tmp_path / "tp")])
    log = open(os.path.join(run, "log.txt")).read()
    assert "world size: 2 |" in log and "grid: 1 data x 2 model ranks | fsdp: False | tp: pair " \
        "rows over 2 model ranks, kernels off" in log
    single = _finish([_popen(synth[:-2] + ["--log_freq", "1", "--logdir",
                                           str(tmp_path / "single")])])
    assert single
    got, want = _metric_losses(tmp_path / "tp"), _metric_losses(tmp_path / "single")
    assert set(got) == set(want) == {1, 2}
    for it in want:
        np.testing.assert_allclose(got[it], want[it], rtol=1e-5, err_msg=f"iteration {it}")


def test_tp_must_divide_the_world(monkeypatch, tmp_path):
    monkeypatch.setattr(dist, "local_world", lambda device=None: 2)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    with pytest.raises(RuntimeError, match="--tp 3 must divide the world size 2"):
        train_main(["--synthetic", "--device", "cpu", "--tp", "3", "--logdir", str(tmp_path)])


@pytest.mark.parametrize("flags", [["--fsdp"], ["--tp", "2"]])
def test_dp_manual_with_fsdp_or_tp_exits_with_the_message(flags, tmp_path):
    with pytest.raises(SystemExit, match=re.escape(DP_MANUAL_GRID)):
        train_main(["--synthetic", "--device", "cpu", "--logdir", str(tmp_path), "--dp_manual",
                    *flags])
    assert not any(tmp_path.iterdir())
