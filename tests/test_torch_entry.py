"""The port's entry points: they run on CUDA unless the CPU is asked for,
raise without CUDA, and load neither JAX nor the JAX package (the static
check of the port's imports: tests/test_torch_imports.py); the train CLI's
checkpoints load strict in the reference layout and resume."""

import glob
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from pepflowww_torch import device as port_device
from pepflowww_torch.convert import load_state_dict, read_torch_checkpoint
from pepflowww_torch.models.flow import FlowModel, FlowModelConfig, build_model
from pepflowww_torch.models.trunk import IPAConfig
from pepflowww_torch.sample import main as sample_main
from pepflowww_torch.train import main as train_main
from pepflowww_torch.training import checkpoints
from pepflowww_torch.training.optim import Optimizer, PlateauScheduler

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "pepflowww_tpu")


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_without_cuda_raise(monkeypatch, tmp_path):
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_device.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_model(FlowModelConfig(ipa=IPAConfig(num_blocks=1)))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sample_main(["--synthetic", "--out", str(tmp_path), "--num_samples", "1",
                     "--num_steps", "2", "--max_complexes", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_main(["--synthetic", "--logdir", str(tmp_path)])
    assert not any(tmp_path.iterdir())
    assert port_device.resolve_device("cpu") == torch.device("cpu")


def test_serve_cli_without_cuda_raises_and_binds_no_port(monkeypatch):
    from pepflowww_torch import serve

    _no_cuda(monkeypatch)
    bound = []
    monkeypatch.setattr(serve, "_Server", lambda *a, **k: bound.append(a))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--synthetic_weights", "--port", "0",
                    "--config", os.path.join(ROOT, "configs", "learn_angle_tpu.yaml")])
    assert bound == []


def test_dp_flags_and_dp_without_cuda_raise(monkeypatch, tmp_path):
    """The multi-device flags of the three CLIs, under the JAX CLIs' names;
    with ``--dp`` and without CUDA each raises before it starts a rank,
    spawns one or binds a port."""
    from pepflowww_torch import sample, serve, train
    from pepflowww_torch.parallel import dist

    assert {"--dp", "--dp_manual", "--multihost", "--coordinator_address", "--num_processes",
            "--process_id"} <= set(train._parser()._option_string_actions)
    assert "--dp" in sample._parser()._option_string_actions
    assert "--dp" in serve._parser()._option_string_actions
    _no_cuda(monkeypatch)
    started = []
    monkeypatch.setattr(dist, "init", lambda *a, **k: started.append(("init", a)))
    monkeypatch.setattr(dist, "launch", lambda *a, **k: started.append(("launch", a)))
    monkeypatch.setattr(serve, "_Server", lambda *a, **k: started.append(("bind", a)))
    for argv, main in ((["--synthetic", "--dp", "--logdir", str(tmp_path)], train_main),
                       (["--synthetic", "--multihost", "--logdir", str(tmp_path)], train_main),
                       (["--synthetic", "--dp", "--out", str(tmp_path)], sample_main),
                       (["--synthetic_weights", "--dp", "--port", "0"], serve.main)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(argv)
    assert started == [] and not any(tmp_path.iterdir())


def test_fsdp_tp_flags_and_without_cuda_raise(monkeypatch, tmp_path):
    """JAX's ``--fsdp``, ``--tp N``, ``--pp N`` and ``--pp_microbatches M`` in
    the train CLI and ``--tp N`` in the sample CLI and the server, which
    take no ``--pp`` (JAX's do not: argparse refuses it); without CUDA each
    raises before it starts a rank, spawns one or binds a port."""
    from pepflowww_torch import sample, serve, train
    from pepflowww_torch.parallel import dist

    assert {"--fsdp", "--tp", "--pp", "--pp_microbatches"} <= set(
        train._parser()._option_string_actions)
    assert train._parser().parse_args(["--pp", "2"]).pp_microbatches == 4
    assert "--tp" in sample._parser()._option_string_actions
    assert "--tp" in serve._parser()._option_string_actions
    for parser in (sample._parser(), serve._parser()):
        assert "--pp" not in parser._option_string_actions
        with pytest.raises(SystemExit):
            parser.parse_args(["--pp", "2"])
    _no_cuda(monkeypatch)
    started = []
    monkeypatch.setattr(dist, "init", lambda *a, **k: started.append(("init", a)))
    monkeypatch.setattr(dist, "launch", lambda *a, **k: started.append(("launch", a)))
    monkeypatch.setattr(serve, "_Server", lambda *a, **k: started.append(("bind", a)))
    for argv, main in ((["--synthetic", "--fsdp", "--logdir", str(tmp_path)], train_main),
                       (["--synthetic", "--tp", "2", "--logdir", str(tmp_path)], train_main),
                       (["--synthetic", "--pp", "2", "--logdir", str(tmp_path)], train_main),
                       (["--synthetic", "--pp", "2", "--fsdp", "--pp_microbatches", "2",
                         "--logdir", str(tmp_path)], train_main),
                       (["--synthetic", "--tp", "2", "--out", str(tmp_path)], sample_main),
                       (["--synthetic_weights", "--tp", "2", "--port", "0"], serve.main)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(argv)
    assert started == [] and not any(tmp_path.iterdir())


def test_sample_cli_on_cpu_writes_pdbs(tmp_path, capsys):
    """The production profile (configs/learn_angle_tpu.yaml: 6 blocks, bf16,
    kernels on) on the CPU, where the kernels take their plain versions."""
    sample_main(["--config", os.path.join(ROOT, "configs", "learn_angle_tpu.yaml"),
                 "--synthetic", "--out", str(tmp_path), "--num_samples", "2",
                 "--num_steps", "2", "--max_complexes", "1", "--device", "cpu"])
    pdbs = sorted(glob.glob(str(tmp_path / "synth0" / "*.pdb")))
    assert len(pdbs) == 2
    atoms = [ln for ln in open(pdbs[0]).read().splitlines() if ln.startswith("ATOM")]
    xyz = np.array([[float(ln[30:38]), float(ln[38:46]), float(ln[46:54])] for ln in atoms])
    assert len([ln for ln in atoms if ln[12:16] == " CA "]) == 60 and np.isfinite(xyz).all()
    assert "2 pdbs" in capsys.readouterr().out


def test_cpu_forward_loads_no_jax():
    """In a fresh interpreter, a CPU sampling run of the port leaves no JAX
    module and no JAX-package module in sys.modules."""
    code = (
        "import sys, numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "from pepflowww_torch.data.collate import device_batch\n"
        "from pepflowww_torch.data.synthetic import make_batch\n"
        "from pepflowww_torch.models.flow import FlowModelConfig, build_model\n"
        "from pepflowww_torch.models.trunk import IPAConfig\n"
        "from pepflowww_torch.sampling import euler_sample\n"
        "cfg = FlowModelConfig(ipa=IPAConfig(num_blocks=2, dtype='bfloat16', use_pallas=True))\n"
        "m = build_model(cfg, 'cpu')\n"
        "b = device_batch(make_batch(np.random.default_rng(0), batch_size=2, pep_len=4,"
        " rec_len=8, pad_to=16), 'cpu')\n"
        "out = euler_sample(m, b, torch.Generator().manual_seed(0), num_steps=2)\n"
        "assert torch.isfinite(out['trans']).all()\n"
        f"print(sorted(k for k in sys.modules if k.split('.')[0] in {FORBIDDEN!r}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env={**env, "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]"


def test_train_cli_on_cpu_checkpoints_and_resumes(tmp_path, capsys, golden):
    """The production profile (6 blocks, bf16, kernels on, 6,880,353
    parameters) trains on the CPU: finite losses, a checkpoint at val_freq
    whose model is the reference state dict (the keys and shapes of the
    reference nb=6 weights, loaded strict), and --resume continues after it."""
    common = ["--config", os.path.join(ROOT, "configs", "learn_angle_tpu.yaml"), "--synthetic",
              "--debug", "--device", "cpu", "--log_freq", "2", "--batch_size", "2",
              "--val_freq", "4", "--logdir", str(tmp_path)]
    run_dir = train_main(common + ["--max_iters", "4"])
    log = capsys.readouterr().err
    assert "Number of parameters: 6880353" in log
    losses = [float(x) for x in re.findall(r"it \d+ \| loss ([-\d.]+)", log)]
    assert len(losses) == 2 and np.isfinite(losses).all(), log
    assert "val it 4" in log
    ckpt_dir = os.path.join(run_dir, "checkpoints")
    path = checkpoints.latest_checkpoint(ckpt_dir)
    assert path == os.path.join(ckpt_dir, "4.pt")

    ref = {k[4:]: g for k, g in golden("model_parity6").items() if k.startswith("sd::")}
    sd = read_torch_checkpoint(path)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {k: v.shape for k, v in ref.items()}
    model = FlowModel(FlowModelConfig(ipa=IPAConfig(num_blocks=6)))
    load_state_dict(model, sd)

    train_main(common + ["--max_iters", "5", "--resume", ckpt_dir, "--log_freq", "1"])
    log = capsys.readouterr().err
    assert "at iteration 5" in log and re.findall(r"it (\d+) \| loss", log) == ["5"], log


def test_checkpoint_round_trip(tmp_path):
    """save -> latest -> restore brings back the weights, the Adam moments,
    the accumulation state and the scheduler, and the iteration."""
    cfg = FlowModelConfig(ipa=IPAConfig(c_s=32, c_z=16, c_hidden=8, no_heads=2, no_qk_points=2,
                                        no_v_points=3, seq_tfmr_num_layers=1, num_blocks=1),
                          node_embed_size=32, edge_embed_size=16)
    model = build_model(cfg, "cpu", seed=1)
    opt = Optimizer(model.parameters(), {"type": "adam", "lr": 1e-3}, 100.0, accum_grad=2)
    for _ in range(3):
        for p in model.parameters():
            p.grad = torch.randn_like(p)
        opt.step()
    sched = PlateauScheduler()
    sched.step(1.0, 1e-3)
    checkpoints.save_checkpoint(str(tmp_path), 7, model, opt, sched, {"train": {"seed": 1}})
    checkpoints.save_checkpoint(str(tmp_path), 12, model, opt, sched, {"train": {"seed": 1}})
    assert checkpoints.latest_checkpoint(str(tmp_path)) == str(tmp_path / "12.pt")

    model2 = build_model(cfg, "cpu", seed=2)
    opt2 = Optimizer(model2.parameters(), {"type": "adam", "lr": 1e-3}, 100.0, accum_grad=2)
    sched2 = PlateauScheduler()
    assert checkpoints.restore_checkpoint(str(tmp_path), model2, opt2, sched2) == 12
    for a, b in zip(model.state_dict().values(), model2.state_dict().values()):
        assert torch.equal(a, b)
    assert opt2.mini_step == opt.mini_step == 1
    for a, b in zip(opt.acc, opt2.acc):
        assert torch.equal(a, b)
    st, st2 = opt.opt.state_dict()["state"], opt2.opt.state_dict()["state"]
    assert all(torch.equal(st[k]["exp_avg_sq"], st2[k]["exp_avg_sq"]) for k in st)
    assert sched2.state_dict() == sched.state_dict()
