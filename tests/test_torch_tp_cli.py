"""The port's sample CLI and server with ``--tp`` over two CPU processes
(torchrun's environment, gloo), the train CLI's stop request, and the
sharded optimizer in one process.

* ``python -m pepflowww_torch.sample --tp 2`` writes the rows, metrics and
  PDBs of one process at the same seed (one data rank draws what one
  process draws).
* ``python -m pepflowww_torch.serve --tp 2`` reports the grid and the plain
  profile on /healthz and answers a request with the PDBs of a
  single-process server of the plain profile at the same seed.
* A SIGTERM that lands while the ranks agree on stopping (inside
  ``dist.any_flag``, after it read the flag) is not lost: the train CLI
  checkpoints and stops at the next iteration (the fault behind
  tests/test_torch_dp_cli.py's SIGTERM test failing under load).
* A ShardedOptimizer of one data rank steps as the Optimizer does with
  accumulation and a clip that bites, and keeps its state-dict layout.
"""

import contextlib
import csv
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

from pepflowww_torch import serve
from pepflowww_torch.data.collate import mask_select_data
from pepflowww_torch.data.pdb import save_pdb
from pepflowww_torch.data.synthetic import make_complex
from pepflowww_torch.parallel import dist
from pepflowww_torch.sample import main as sample_main
from pepflowww_torch.train import main as train_main

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 180
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
  batch_size: 1
  val_freq: 1000
"""


@contextlib.contextmanager
def _one_thread():
    """The ranks' thread count (OMP_NUM_THREADS=1) for a reference computed
    in this process: another module's count would change the CPU's
    reduction order."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _env(i, port):
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    return {**env, "OMP_NUM_THREADS": "1", "RANK": str(i), "WORLD_SIZE": "2",
            "LOCAL_RANK": str(i), "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port}


def _ranks(module, argv):
    port = str(dist.free_port())
    return [subprocess.Popen([sys.executable, "-m", module, "--device", "cpu", *argv], cwd=ROOT,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                             env=_env(i, port)) for i in range(2)]


def _yaml(tmp_path):
    path = tmp_path / "tiny.yaml"
    path.write_text(TINY_YAML)
    return str(path)


def test_sample_cli_tp_writes_the_single_process_samples(tmp_path):
    cfg = _yaml(tmp_path)
    argv = ["--config", cfg, "--synthetic", "--num_samples", "3", "--num_steps", "2",
            "--max_complexes", "1"]
    procs = _ranks("pepflowww_torch.sample", argv + ["--tp", "2", "--out", str(tmp_path / "tp")])
    with _one_thread():
        sample_main(argv + ["--device", "cpu", "--out", str(tmp_path / "one")])
    outs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], "\n=====\n".join(outs)
    assert "grid: 1 data x 2 model ranks; pair rows over 2 model ranks" in outs[0]
    assert "wrote 3 rows" in outs[0] and "wrote" not in outs[1]
    rows = [list(csv.DictReader(open(tmp_path / d / "outputs.csv"))) for d in ("tp", "one")]
    assert rows[0] == rows[1] and len(rows[0]) == 3
    for i in range(3):
        assert (open(tmp_path / "tp" / "synth0" / f"sample_{i}.pdb").read()
                == open(tmp_path / "one" / "synth0" / f"sample_{i}.pdb").read())


def test_server_tp_answers_with_the_single_process_pdbs(tmp_path):
    cfg = _yaml(tmp_path)
    item = make_complex(np.random.default_rng(0), pep_len=5, rec_len=12)
    req = {"pocket_pdb": save_pdb(mask_select_data(item, ~item["generate_mask"])),
           "peptide_pdb": save_pdb(mask_select_data(item, item["generate_mask"])),
           "num_samples": 2, "num_steps": 2}
    procs = _ranks("pepflowww_torch.serve", ["--config", cfg, "--tp", "2",
                                             "--synthetic_weights", "--port", "0"])
    lines = [[], []]
    readers = [threading.Thread(target=lambda i=i: lines[i].extend(procs[i].stdout), daemon=True)
               for i in range(2)]
    for t in readers:
        t.start()
    try:
        with _one_thread():
            state = serve.start(serve._parser().parse_args(["--config", cfg,
                                                            "--synthetic_weights", "--device",
                                                            "cpu"]))
            want = serve._sample(state, dict(req))
        t0 = time.time()
        while not any("listening on" in ln for ln in lines[0]):
            assert time.time() - t0 < TIMEOUT and procs[0].poll() is None, "".join(lines[0])
            time.sleep(0.2)
        text = "".join(lines[0])
        assert "plain profile on cpu, data-parallel over 1 ranks, pair rows over 2 model " \
               "ranks" in text
        port = int(re.search(r"listening on http://[\d.]+:(\d+)", text).group(1))
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=TIMEOUT) as r:
            health = json.loads(r.read())
        assert health["world_size"] == 2 and health["tp"]["model_ranks"] == 2
        assert health["tp"]["data_ranks"] == 1 and health["tp"]["profile"] == "plain"
        post = urllib.request.Request(f"http://127.0.0.1:{port}/sample",
                                      data=json.dumps(req).encode(),
                                      headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(post, timeout=TIMEOUT) as r:
            got = json.loads(r.read())
        assert len(got["pdbs"]) == 2 and got["pdbs"] == want["pdbs"]
        assert got["metrics"] == want["metrics"]
        procs[0].send_signal(signal.SIGTERM)
        assert [p.wait(TIMEOUT) for p in procs] == [0, 0], "".join(lines[0] + lines[1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def test_stop_request_inside_the_agreement_is_kept(monkeypatch, tmp_path):
    """The train CLI with --dp in a world of one: a SIGTERM delivered inside
    ``dist.any_flag`` of iteration 2, after the flag was read, stops the
    run at iteration 3 with one checkpoint, where an overwritten flag would
    train on to --max_iters."""
    real = dist.any_flag
    calls = []

    def any_flag(flag):
        out = real(flag)
        calls.append(flag)
        if len(calls) == 2:
            os.kill(os.getpid(), signal.SIGTERM)   # its handler runs before this returns
        return out

    monkeypatch.setattr(dist, "any_flag", any_flag)
    run = train_main(["--config", _yaml(tmp_path), "--synthetic", "--dp", "--device", "cpu",
                      "--max_iters", "20", "--log_freq", "1", "--logdir", str(tmp_path / "logs")])
    assert calls == [False, False, True]
    assert os.listdir(os.path.join(run, "checkpoints")) == ["3.pt"]
    log = open(os.path.join(run, "log.txt")).read()
    assert "exiting at iteration 3 after preemption checkpoint" in log


def test_sharded_optimizer_accumulates_clips_and_keeps_the_single_layout():
    """A ShardedOptimizer of one data rank against the Optimizer on the same
    gradients, accum_grad=3 and a clip at 1.0 that bites: the parameters
    after six steps agree, its state dict has the Optimizer's layout and
    values, and it loads back."""
    from pepflowww_torch.parallel.fsdp import ShardedOptimizer
    from pepflowww_torch.training.optim import Optimizer

    gen = torch.Generator().manual_seed(0)
    grads = [[torch.randn(5, 3, generator=gen) * 3, torch.randn(5, generator=gen) * 3]
             for _ in range(6)]
    cfg = {"type": "adamw", "lr": 1e-2, "weight_decay": 0.1}
    dist.init("cpu")
    try:
        dist.setup_grid(1)
        mods = [torch.nn.Linear(3, 5) for _ in range(2)]
        mods[1].load_state_dict(mods[0].state_dict())
        plain = Optimizer(mods[0].parameters(), cfg, 1.0, accum_grad=3)
        sharded = ShardedOptimizer(mods[1].parameters(), cfg, 1.0, accum_grad=3)
        for g in grads:
            flat = plain.flat_grads(2)
            flat[:-2].copy_(torch.cat([x.reshape(-1) for x in g]))
            plain.step()
            flat = sharded.flat_grads(2)
            for p, x in zip(mods[1].parameters(), g):
                p.grad.copy_(x)
            sharded.reduce_grads(flat, 2)
            sharded.step()
        with sharded.gathered():
            for p, q in zip(mods[0].parameters(), mods[1].parameters()):
                torch.testing.assert_close(q, p, atol=1e-6, rtol=0)
        want, got = plain.state_dict(), sharded.state_dict()
        assert got["mini_step"] == want["mini_step"] == 0
        for i, st in want["optimizer"]["state"].items():
            for k, v in st.items():
                torch.testing.assert_close(got["optimizer"]["state"][i][k].cpu(), v.cpu(),
                                           atol=1e-6, rtol=0)
        sharded.load_state_dict(want)
        assert sharded.state_dict()["optimizer"]["param_groups"] == \
            want["optimizer"]["param_groups"]
    finally:
        dist.destroy()
