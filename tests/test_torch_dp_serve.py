"""The port's server under ``--dp`` (``pepflowww_torch/serve.py``).

In this process, with a stand-in for the ranks: at a world of 2 the
merge cap is 128 rows (64 x world, as the JAX server's
``64 * n_devices``), a 3-sample request goes out as one group of 4 rows
(``_pad_rule(3, 2)``), and ``warmup_sizes(2)`` is the image of
``_pad_rule(., 2)`` over 1 ... 128, the JAX ladder's sizes and the two
below its floor of 8. Then the CLI as two CPU processes (torchrun's
environment, gloo): concurrent requests at two length buckets all come
back whole, each group padded to a multiple of the world size, and a
SIGTERM to rank 0 ends both ranks (rank 0 releases rank 1), as
tests/test_serve.py holds the JAX ``--dp`` server.
"""

import concurrent.futures
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

import serve as jax_serve

from pepflowww_torch import serve
from pepflowww_torch.data.collate import mask_select_data
from pepflowww_torch.data.pdb import save_pdb
from pepflowww_torch.data.synthetic import make_complex
from pepflowww_torch.models.flow import FlowModelConfig, build_model
from pepflowww_torch.models.trunk import IPAConfig
from pepflowww_torch.parallel import dist

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120
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
      num_blocks: 1
"""


def _pdbs(seed, pep_len, rec_len):
    item = make_complex(np.random.default_rng(seed), pep_len=pep_len, rec_len=rec_len)
    return (save_pdb(mask_select_data(item, item["generate_mask"])),
            save_pdb(mask_select_data(item, ~item["generate_mask"])))


def _post(port, obj):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/sample", data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
        return resp.status, json.loads(resp.read())


class _Ranks:
    """A stand-in :class:`serve.Dispatcher` for a world of 2: records each
    group and samples all its rows in this process."""

    def __init__(self, model):
        self.model, self.groups = model, []

    def run(self, group):
        from pepflowww_torch.data.collate import device_batch, pad_and_collate

        bucket, steps, rows, seed = group
        self.groups.append((bucket, steps, len(rows), seed))
        batch = device_batch(pad_and_collate(rows, pad_to=bucket), "cpu")
        out = serve._make_group_sampler(steps)(self.model, batch,
                                               torch.Generator().manual_seed(seed))
        return out, {}


def test_merge_cap_pad_and_ladder_at_two_ranks(capsys):
    cfg = FlowModelConfig(node_embed_size=32, edge_embed_size=16,
                          ipa=IPAConfig(c_s=32, c_z=16, c_hidden=8, no_heads=2, no_qk_points=2,
                                        no_v_points=3, seq_tfmr_num_heads=2,
                                        seq_tfmr_num_layers=1, num_blocks=1))
    model = build_model(cfg, "cpu", seed=0)
    state = serve.ServeState(model, torch.device("cpu"), "test")
    state.world, state.dispatcher = 2, _Ranks(model)
    pep_pdb, pocket_pdb = _pdbs(0, 5, 12)
    out = serve._sample(state, {"pocket_pdb": pocket_pdb, "peptide_pdb": pep_pdb,
                                "num_samples": 3, "num_steps": 2})
    assert state.scheduler.max_batch == 128
    assert state.dispatcher.groups == [(32, 2, 4, 1)] and len(out["pdbs"]) == 3
    assert "[serve] group bucket=32 n=3/4 steps=2 " in capsys.readouterr().out
    ladder = serve.warmup_sizes(2)
    assert ladder == sorted({serve._pad_rule(n, 2) for n in range(1, 129)}) == [2, 4, 8, 16, 32,
                                                                                64, 128]
    assert all(serve._pad_rule(n, 2) == jax_serve._pad_rule(n, 2) == serve._group_pad_size(n, 2)
               for n in range(1, 129))
    assert sorted(set(ladder) - set(jax_serve.warmup_sizes(2))) == [2, 4]


def test_two_rank_server_answers_two_buckets_and_stops(tmp_path):
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(TINY_YAML)
    port = str(dist.free_port())
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    procs = [subprocess.Popen(
        [sys.executable, "-m", "pepflowww_torch.serve", "--config", str(cfg), "--dp",
         "--synthetic_weights", "--port", "0", "--device", "cpu"], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**env, "OMP_NUM_THREADS": "1", "RANK": str(i), "WORLD_SIZE": "2",
             "LOCAL_RANK": str(i), "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port})
        for i in range(2)]
    lines = [[], []]
    readers = [threading.Thread(target=lambda i=i: lines[i].extend(procs[i].stdout), daemon=True)
               for i in range(2)]
    for t in readers:
        t.start()
    try:
        t0 = time.time()
        while not any("listening on" in ln for ln in lines[0]):
            assert time.time() - t0 < TIMEOUT and procs[0].poll() is None, "".join(lines[0])
            time.sleep(0.2)
        http_port = int(re.search(r"listening on http://[\d.]+:(\d+)",
                                  "".join(lines[0])).group(1))
        with urllib.request.urlopen(f"http://127.0.0.1:{http_port}/healthz",
                                    timeout=TIMEOUT) as resp:
            assert json.loads(resp.read()) == {"status": "ok", "device": "cpu", "world_size": 2}
        reqs = []
        for i, (pep, rec) in enumerate([(5, 12), (8, 50)] * 4):
            pep_pdb, pocket_pdb = _pdbs(i, pep, rec)
            reqs.append(({"pocket_pdb": pocket_pdb, "peptide_pdb": pep_pdb, "num_samples": 3,
                          "num_steps": 2}, pep))
        with concurrent.futures.ThreadPoolExecutor(len(reqs)) as ex:
            outs = list(ex.map(lambda r: _post(http_port, r[0]), reqs))
        for (code, out), (_, pep) in zip(outs, reqs):
            assert code == 200 and len(out["pdbs"]) == 3, out
            assert all(np.isfinite(out["metrics"]["ca_rmsd"]))
            assert all(len({ln[22:27] for ln in p.splitlines()
                            if ln.startswith("ATOM") and ln[21] == "A"}) == pep
                       for p in out["pdbs"])
        groups = [tuple(map(int, m.groups())) for m in re.finditer(
            r"group bucket=(\d+) n=(\d+)/(\d+) steps=2 .* ranks=2", "".join(lines[0]))]
        assert {b for b, _, _ in groups} == {32, 64}
        assert sum(n for _, n, _ in groups) == 24 and all(p % 2 == 0 for _, _, p in groups)
        procs[0].send_signal(signal.SIGTERM)
        assert [p.wait(TIMEOUT) for p in procs] == [0, 0], "".join(lines[0] + lines[1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
