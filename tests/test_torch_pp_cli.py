"""The port's train CLI with ``--pp`` over CPU processes (gloo), each a
fresh interpreter that imports only the port.

* ``--pp 2 --pp_microbatches 2`` over two spawned ranks (one pipe group)
  logs the losses of one process at the same batch (the plain profile),
  validation included, and says so in its grid line.
* Its checkpoint holds the single process's layout and resumes strict in
  one process; the single process's checkpoint resumes under
  ``--pp 2 --fsdp``, whose iteration 3 is the one process's.
* The refusals exit with the JAX package's words: ``--pp 1``, N not
  dividing the world size, num_blocks not dividing over N, the batch not
  dividing into M microbatches, ``--pp`` with ``--tp`` and ``--dp_manual``
  with ``--pp``; the sample CLI and the server take no ``--pp`` (JAX's do
  not).
"""

import os
import re

import numpy as np
import pytest
import torch

from test_torch_fsdp_cli import TINY_YAML, _ckpt, _finish, _losses, _metric_losses, _popen
from pepflowww_torch import sample, serve
from pepflowww_torch.convert import load_state_dict
from pepflowww_torch.models.flow import FlowModel
from pepflowww_torch.parallel import dist, pp
from pepflowww_torch.train import DP_MANUAL_GRID
from pepflowww_torch.train import main as train_main

torch.set_num_threads(1)


def _spawn_two(monkeypatch):
    """Count two devices, so that the CLI spawns two ranks."""
    monkeypatch.setattr(dist, "local_world", lambda device=None: 2)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _config(root, **ipa) -> str:
    text = TINY_YAML
    for k, v in ipa.items():
        text = re.sub(rf"{k}: \d+", f"{k}: {v}", text)
    path = os.path.join(str(root), f"tiny{''.join(f'_{k}{v}' for k, v in ipa.items())}.yaml")
    with open(path, "w") as f:
        f.write(text)
    return path


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two spawned --pp 2 ranks and one process, synthetic batches of 4,
    2 iterations, validation and a checkpoint at 2."""
    root = tmp_path_factory.mktemp("pp_cli")
    cfg = _config(root)
    synth = ["--config", cfg, "--synthetic", "--batch_size", "4", "--log_freq", "1",
             "--val_freq", "2"]
    single = _popen(synth + ["--max_iters", "2", "--logdir", str(root / "single")])
    mp = pytest.MonkeyPatch()
    try:
        _spawn_two(mp)
        run = train_main(synth + ["--device", "cpu", "--max_iters", "2", "--pp", "2",
                                  "--pp_microbatches", "2", "--logdir", str(root / "pp")])
    finally:
        mp.undo()
    out = _finish([single])[0]
    return {"root": root, "synth": synth, "cfg": cfg, "single": out,
            "log": open(os.path.join(run, "log.txt")).read()}


def test_pp_two_spawned_ranks_follow_the_single_process(runs):
    log = runs["log"]
    assert "world size: 2 |" in log
    assert ("grid: 1 data x 2 pipe ranks | fsdp: False | pp: 2 stages of 1 blocks, 2 "
            "microbatches of 2 rows, bubble 0.333, kernels off") in log, log[-2000:]
    got, want = _metric_losses(runs["root"] / "pp"), _metric_losses(runs["root"] / "single")
    assert set(got) == set(want) == {1, 2}
    val = re.findall(r"val it 2 \| loss=([-\d.]+)", log)
    assert val == re.findall(r"val it 2 \| loss=([-\d.]+)", runs["single"])
    gap = max(abs(got[i] / want[i] - 1) for i in want)
    print(f"--pp 2 over two ranks against one process, B=4: losses {got} vs {want}, largest "
          f"relative gap {gap:.2e}; validation loss {val}")
    for it in want:
        np.testing.assert_allclose(got[it], want[it], rtol=1e-5, err_msg=f"iteration {it}")


def test_pp_checkpoint_is_the_single_layout_and_resumes(runs, monkeypatch):
    """Checkpoint 2 of the --pp run against the single process's: the same
    keys and shapes, optimizer state per parameter; one process resumes it
    strict, and two --pp 2 --fsdp ranks resume the single process's, both
    at iteration 3 with the same loss."""
    root = runs["root"]
    mine = torch.load(_ckpt(root / "pp", 2), map_location="cpu", weights_only=False)
    ref = torch.load(_ckpt(root / "single", 2), map_location="cpu", weights_only=False)
    assert {k: v.shape for k, v in mine["model"].items()} == \
        {k: v.shape for k, v in ref["model"].items()}
    from pepflowww_torch.config import load_train_config

    load_state_dict(FlowModel(load_train_config(runs["cfg"])[0]), mine["model"])
    mo, ro = mine["optimizer"]["optimizer"], ref["optimizer"]["optimizer"]
    assert sorted(mo["state"]) == sorted(ro["state"])
    for i, st in ro["state"].items():
        assert float(mo["state"][i]["step"]) == float(st["step"]) == 2.0
        for k in ("exp_avg", "exp_avg_sq"):
            assert mo["state"][i][k].shape == st[k].shape, (i, k)
    one = _popen(runs["synth"] + ["--max_iters", "3", "--logdir", str(root / "resume1"),
                                  "--resume", _ckpt(root / "pp", 2)])
    _spawn_two(monkeypatch)
    run = train_main(runs["synth"] + ["--device", "cpu", "--max_iters", "3", "--pp", "2",
                                      "--pp_microbatches", "2", "--fsdp", "--logdir",
                                      str(root / "resume2"), "--resume", _ckpt(root / "single", 2)])
    out = _finish([one])[0]
    log = open(os.path.join(run, "log.txt")).read()
    assert "at iteration 3" in out and "at iteration 3" in log
    assert "grid: 1 data x 2 pipe ranks | fsdp: True | pp: 2 stages" in log
    assert set(_losses(out)) == {3}
    got, want = _metric_losses(root / "resume2"), _metric_losses(root / "resume1")
    assert set(got) == set(want) == {3}
    np.testing.assert_allclose(got[3], want[3], rtol=1e-5)


@pytest.mark.parametrize("case", ["one stage", "world", "blocks", "batch"])
def test_pp_refusals_exit_with_jax_words(case, monkeypatch, tmp_path):
    """``--pp 1`` in a world of one; on two spawned ranks ``--pp 3``, a
    three-block model at ``--pp 2``, and a batch of 4 in 3 microbatches."""
    argv = ["--synthetic", "--device", "cpu", "--logdir", str(tmp_path / "logs"),
            "--max_iters", "1"]
    if case == "one stage":
        with pytest.raises(SystemExit, match=re.escape(pp.STAGES)):
            train_main(argv + ["--config", _config(tmp_path), "--pp", "1"])
        assert not (tmp_path / "logs").exists()
        return
    _spawn_two(monkeypatch)
    argv += {"world": ["--config", _config(tmp_path), "--pp", "3"],
             "blocks": ["--config", _config(tmp_path, num_blocks=3), "--pp", "2"],
             "batch": ["--config", _config(tmp_path), "--pp", "2", "--batch_size", "4",
                       "--pp_microbatches", "3"]}[case]
    words = {"world": "--pp 3 must divide the world size 2",
             "blocks": "num_blocks 3 must divide over 2 pipeline stages",
             "batch": "batch 4 must divide into 1 data shards x 3 microbatches"}[case]
    with pytest.raises(RuntimeError, match=re.escape(words)):
        train_main(argv)
    assert not (tmp_path / "logs").exists()


def test_pp_with_tp_or_dp_manual_exits_and_only_train_takes_pp(tmp_path, capsys):
    """``--pp`` with ``--tp`` exits with the JAX CLI's argparse error,
    ``--dp_manual`` with ``--pp`` with DP_MANUAL_GRID, before any rank
    starts; the sample CLI and the server refuse ``--pp``."""
    argv = ["--synthetic", "--device", "cpu", "--logdir", str(tmp_path)]
    with pytest.raises(SystemExit) as e:
        train_main(argv + ["--pp", "2", "--tp", "2"])
    assert e.value.code == 2 and pp.PP_TP in capsys.readouterr().err
    with pytest.raises(SystemExit, match=re.escape(DP_MANUAL_GRID)):
        train_main(argv + ["--pp", "2", "--dp_manual"])
    assert not any(tmp_path.iterdir())
    for parser in (sample._parser(), serve._parser()):
        assert "--pp" not in parser._option_string_actions
        with pytest.raises(SystemExit):
            parser.parse_args(["--pp", "2"])
