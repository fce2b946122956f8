"""The port's data-parallel CLIs over two CPU processes (gloo), each a
fresh interpreter that imports only the port.

* ``python -m pepflowww_torch.train --multihost --coordinator_address
  127.0.0.1:<free port> --num_processes 2 --process_id i`` with
  ``--batch_size 2`` on a PepMerge-style directory logs the per-iteration
  losses of one process with ``--batch_size 4`` within the JAX test's rtol
  5e-3 (tests/test_multihost.py): the loader's shards assemble the same
  global batches, and the corruption is drawn for the global batch from
  one seed on every rank.
* That run leaves one run directory and one checkpoint, in the reference's
  names, and a single process resumes from it (strict) at iteration 3.
* ``python -m pepflowww_torch.sample --dp`` over two ranks (torchrun's
  environment) with 3 samples a complex writes 3 rows a complex.
* ``--dp_manual`` with ``--multihost`` exits with the JAX CLI's message.
* ``--dp`` on a host of two devices (two stood in for GPUs by the test)
  spawns one rank each, which train as one run; ``dist.launch``, which
  spawns them, raises with a failing rank's traceback and ends the others,
  and passes a SIGTERM sent to the CLI on to its ranks, which checkpoint
  once and stop.
"""

import csv
import glob
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import torch_dp_ranks
from pepflowww_torch.convert import load_state_dict, read_torch_checkpoint
from pepflowww_torch.data.dataset import PepDataset
from pepflowww_torch.data.synthetic import write_structure_dir
from pepflowww_torch.models.flow import FlowModel
from pepflowww_torch.parallel import dist
from pepflowww_torch.train import main as train_main

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300
TINY_YAML = """\
model:
  encoder:
    node_embed_size: 64
    edge_embed_size: 32
    ipa:
      c_s: 64
      c_z: 32
      c_hidden: 16
      no_heads: 2
      no_qk_points: 2
      no_v_points: 3
      seq_tfmr_num_heads: 2
      seq_tfmr_num_layers: 1
      num_blocks: 1
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


def _popen(module, argv, **env):
    return subprocess.Popen([sys.executable, "-m", module, "--device", "cpu", *argv], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            env=_env(**env))


def _finish(procs):
    outs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), "\n=====\n".join(o[-3000:] for o in outs)
    return outs


def _losses(text):
    return {int(m.group(1)): float(m.group(2)) for m in LOSS_RE.finditer(text)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A 24-complex directory and its cache; one process at B=4 and two
    ranks at B=2, 3 iterations, a checkpoint every 2."""
    root = tmp_path_factory.mktemp("dp_cli")
    sdir, ddir, cfg = str(root / "structs"), str(root / "cache"), str(root / "tiny.yaml")
    write_structure_dir(sdir, n=24, seed=0, min_rec=20, max_rec=40)
    assert len(PepDataset(sdir, ddir, name="mh", n_jobs=1)) == 24   # cache built once, here
    with open(cfg, "w") as f:
        f.write(TINY_YAML)
    common = ["--config", cfg, "--structure_dir", sdir, "--dataset_dir", ddir, "--dataset_name",
              "mh", "--max_iters", "3", "--log_freq", "1", "--val_freq", "2"]
    port = dist.free_port()
    procs = [_popen("pepflowww_torch.train", common + ["--batch_size", "4", "--logdir",
                                                       str(root / "single")])]
    procs += [_popen("pepflowww_torch.train", common + [
        "--batch_size", "2", "--logdir", str(root / "dp"), "--multihost", "--coordinator_address",
        f"127.0.0.1:{port}", "--num_processes", "2", "--process_id", str(i)]) for i in range(2)]
    outs = _finish(procs)
    return {"root": root, "common": common, "single": outs[0], "ranks": outs[1:]}


def _metric_losses(logdir):
    (run,) = os.listdir(logdir)
    with open(os.path.join(logdir, run, "metrics.jsonl")) as f:
        return {r["step"]: r["loss"] for r in map(json.loads, f) if r["tag"] == "train"}


def test_two_ranks_follow_the_single_process(runs):
    """The losses of metrics.jsonl (full precision), and rank 0's log lines."""
    assert set(_losses(runs["single"])) == set(_losses(runs["ranks"][0])) == {1, 2, 3}
    assert _losses(runs["ranks"][1]) == {}   # rank 1 logs nothing
    single, multi = _metric_losses(runs["root"] / "single"), _metric_losses(runs["root"] / "dp")
    assert set(single) == set(multi) == {1, 2, 3}
    gap = max(abs(multi[i] / single[i] - 1) for i in single)
    print(f"two ranks x B=2 against one process x B=4: losses {multi} vs {single}, "
          f"largest relative gap {gap:.2e}")
    for it in single:
        assert np.isfinite(multi[it])
        np.testing.assert_allclose(multi[it], single[it], rtol=5e-3, err_msg=f"iteration {it}")


def test_one_run_dir_one_checkpoint_and_a_single_process_resume(runs):
    logdir = runs["root"] / "dp"
    run_dirs = os.listdir(logdir)
    assert len(run_dirs) == 1, run_dirs
    ckpt_dir = logdir / run_dirs[0] / "checkpoints"
    assert os.listdir(ckpt_dir) == ["2.pt"]
    sd = read_torch_checkpoint(str(ckpt_dir / "2.pt"))
    assert not any(k.startswith("module.") for k in sd)
    from pepflowww_torch.config import load_train_config

    load_state_dict(FlowModel(load_train_config(runs["common"][1])[0]), sd)
    out = _finish([_popen("pepflowww_torch.train", runs["common"] + [
        "--batch_size", "4", "--logdir", str(runs["root"] / "resume"), "--resume",
        str(ckpt_dir)])])[0]
    assert "at iteration 3" in out and set(_losses(out)) == {3}, out[-3000:]


def test_sample_cli_dp_pads_an_odd_count(runs, tmp_path):
    port = str(dist.free_port())
    out_dir = str(tmp_path / "samples")
    argv = ["--config", runs["common"][1], "--synthetic", "--dp", "--num_samples", "3",
            "--num_steps", "2", "--max_complexes", "2", "--out", out_dir]
    outs = _finish([_popen("pepflowww_torch.sample", argv, RANK=str(i), WORLD_SIZE="2",
                           LOCAL_RANK=str(i), MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
                    for i in range(2)])
    assert "wrote 6 rows" in outs[0] and "wrote" not in outs[1]
    with open(os.path.join(out_dir, "outputs.csv")) as f:
        rows = list(csv.DictReader(f))
    assert sorted((r["id"], r["sample"]) for r in rows) == [
        (f"synth{c}", str(s)) for c in range(2) for s in range(3)]
    assert all(len(glob.glob(os.path.join(out_dir, f"synth{c}", "*.pdb"))) == 3 for c in range(2))


def test_dp_manual_with_multihost_exits_with_the_message(tmp_path):
    with pytest.raises(SystemExit, match="--dp_manual is single-process; drop it or drop "
                                         "--multihost"):
        train_main(["--synthetic", "--device", "cpu", "--logdir", str(tmp_path), "--dp_manual",
                    "--multihost"])
    assert not any(tmp_path.iterdir())


def test_launch_raises_with_a_failing_ranks_traceback():
    with pytest.raises(RuntimeError, match=r"(?s)rank 1 failed:.*ValueError: raised on rank 1"):
        dist.launch(torch_dp_ranks.fail_on, 2, (1,))


def test_dp_spawns_one_rank_a_device(runs, monkeypatch, tmp_path):
    """The train CLI's ``--dp`` where ``local_world`` counts two devices:
    two spawned ranks, one run directory (rank 0's, returned) whose log
    names a world of two and whose metrics hold every iteration."""
    monkeypatch.setattr(dist, "local_world", lambda device=None: 2)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    run = train_main(["--config", runs["common"][1], "--synthetic", "--dp", "--device", "cpu",
                      "--batch_size", "1", "--max_iters", "2", "--log_freq", "1", "--logdir",
                      str(tmp_path)])
    assert os.listdir(tmp_path) == [os.path.basename(run)]
    assert "world size: 2 |" in open(os.path.join(run, "log.txt")).read()
    assert set(_metric_losses(tmp_path)) == {1, 2}


def test_sigterm_to_the_spawning_cli_checkpoints_and_stops_every_rank(runs, tmp_path):
    """The train CLI's ``--dp`` spawning two ranks (``local_world`` patched
    to two in its process), SIGTERM sent to the CLI's own process once
    rank 0 logs iteration 2: one checkpoint, and exit code 0 (``launch``
    raises for a rank that exits otherwise)."""
    script = ("import sys\n"
              "from pepflowww_torch.parallel import dist\n"
              "dist.local_world = lambda device=None: 2\n"
              "from pepflowww_torch import train\n"
              "train.main(sys.argv[1:])\n")
    proc = subprocess.Popen(
        [sys.executable, "-c", script, "--config", runs["common"][1], "--synthetic", "--dp",
         "--device", "cpu", "--batch_size", "1", "--max_iters", "100000", "--log_freq", "1",
         "--logdir", str(tmp_path)], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=_env())
    lines = []
    reader = threading.Thread(target=lambda: lines.extend(proc.stdout), daemon=True)
    reader.start()
    try:
        t0 = time.time()
        while 2 not in _losses("".join(lines)):
            assert time.time() - t0 < TIMEOUT and proc.poll() is None, "".join(lines)[-3000:]
            time.sleep(0.2)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(TIMEOUT) == 0, "".join(lines)[-3000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    reader.join(TIMEOUT)
    text = "".join(lines)
    (run,) = os.listdir(tmp_path)
    (ckpt,) = os.listdir(tmp_path / run / "checkpoints")
    it = int(ckpt.removesuffix(".pt"))
    assert it >= 2 and f"exiting at iteration {it} after preemption checkpoint" in text, text
    assert max(_losses(text)) == it
