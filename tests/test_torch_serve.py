"""The port's server and load-test client on the CPU (``pepflowww_torch/
serve.py``, ``serve_loadtest.py``), with the tiny model of
``tests/test_serve.py`` and 2 sampler steps: the HTTP round trip, a merge
held by the test (not by a wall-clock window), a failing group, the 64-row
chunks, the load-test client, and the kernel libraries' build lock and
launch counter under threads (``pepflowww_torch/native.py``)."""

import ast
import concurrent.futures
import json
import os
import stat
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from pepflowww_torch import native, sampling, serve, serve_loadtest
from pepflowww_torch.data.collate import mask_select_data, replicate_item
from pepflowww_torch.data.pdb import save_pdb
from pepflowww_torch.data.synthetic import make_complex
from pepflowww_torch.models.flow import FlowModelConfig, build_model
from pepflowww_torch.models.trunk import IPAConfig

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120


def _pdbs(seed, pep_len=5, rec_len=12):
    item = make_complex(np.random.default_rng(seed), pep_len=pep_len, rec_len=rec_len)
    return (save_pdb(mask_select_data(item, item["generate_mask"])),
            save_pdb(mask_select_data(item, ~item["generate_mask"])))


@pytest.fixture(scope="module")
def server():
    cfg = FlowModelConfig(
        node_embed_size=32, edge_embed_size=16,
        ipa=IPAConfig(c_s=32, c_z=16, c_hidden=8, no_heads=2, no_qk_points=2, no_v_points=3,
                      seq_tfmr_num_heads=2, seq_tfmr_num_layers=1, num_blocks=1))
    state = serve.start(serve._parser().parse_args(["--device", "cpu"]),
                        model=build_model(cfg, "cpu", seed=0))
    srv = serve._Server(("127.0.0.1", 0), state)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield state, srv.server_address[1]
    srv.shutdown()
    srv.server_close()
    thread.join(TIMEOUT)
    assert not thread.is_alive()


def _post(port, obj):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/sample", data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _chain_a_residues(pdb: str) -> int:
    return len({ln[22:27] for ln in pdb.splitlines() if ln.startswith("ATOM") and ln[21] == "A"})


def test_http_round_trip(server):
    state, port = server
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=TIMEOUT) as resp:
        assert json.loads(resp.read()) == {"status": "ok", "device": "cpu"}
    pep_pdb, pocket_pdb = _pdbs(0)
    code, out = _post(port, {"pocket_pdb": pocket_pdb, "peptide_pdb": pep_pdb,
                             "num_samples": 2, "num_steps": 2})
    assert code == 200 and len(out["pdbs"]) == 2 and out["pdbs"][0].startswith("ATOM")
    assert all(len(out["metrics"][k]) == 2 for k in ("ca_rmsd", "aar", "tm_score"))
    assert np.isfinite(out["metrics"]["ca_rmsd"]).all()
    assert _chain_a_residues(out["pdbs"][0]) == 5
    code, out = _post(port, {"pocket_pdb": pocket_pdb, "peptide_len": 6, "num_samples": 1,
                             "num_steps": 2})
    assert code == 200 and len(out["pdbs"]) == 1 and _chain_a_residues(out["pdbs"][0]) == 6
    code, out = _post(port, {"pocket_pdb": "garbage"})
    assert code == 400 and out["error"].startswith("ValueError: ")


def test_requests_pending_together_merge_into_one_call(server, monkeypatch):
    """The first group's sampler waits on an event the test holds; 4
    requests of 2 rows queue behind it under the scheduler's lock (so no
    wall-clock window decides the merge) and run as one call of 8 rows;
    every row runs once and each request gets its own rows back."""
    state, _ = server
    entered, release, calls = threading.Event(), threading.Event(), []
    real = serve._make_group_sampler

    def held(steps):
        fn = real(steps)

        def run(model, batch, generator):
            calls.append(int(batch["aa"].shape[0]))
            if len(calls) == 1:
                entered.set()
                assert release.wait(TIMEOUT)
            return fn(model, batch, generator)
        return run

    monkeypatch.setattr(serve, "_make_group_sampler", held)
    sched = serve.BatchScheduler(lambda key, rows, ctx: serve._run_group(state, key, rows, ctx))
    items = [serve._build_item(dict(zip(("peptide_pdb", "pocket_pdb"), _pdbs(s))))
             for s in range(5)]
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        first = ex.submit(sched.submit, (32, 2), replicate_item(items[0], 2), None)
        assert entered.wait(TIMEOUT)
        with sched.cv:
            queued = [sched._enqueue((32, 2), replicate_item(it, 2), i)
                      for i, it in enumerate(items[1:])]
        release.set()
        assert len(first.result(TIMEOUT)) == 2
    for e in queued:
        assert e["event"].wait(TIMEOUT) and e["error"] is None
    assert calls == [2, 8]
    for e, it in zip(queued, items[1:]):
        assert len(e["result"]) == 2
        assert all(r["pdb"].count(" CA ") == len(it["aa"]) for r in e["result"])


def test_failing_group_gets_400_and_the_others_200(server, monkeypatch):
    state, port = server
    real = serve._make_group_sampler

    def failing(steps):
        if steps == 3:
            raise RuntimeError("injected device failure")
        return real(steps)

    monkeypatch.setattr(serve, "_make_group_sampler", failing)
    monkeypatch.setattr(state, "scheduler", None)
    pep_pdb, pocket_pdb = _pdbs(1)
    good = {"pocket_pdb": pocket_pdb, "peptide_pdb": pep_pdb, "num_samples": 2, "num_steps": 2}
    bad = dict(good, num_steps=3)
    with concurrent.futures.ThreadPoolExecutor(6) as ex:
        results = list(ex.map(lambda i: _post(port, bad if i % 2 else good), range(6)))
    assert [c for c, _ in results] == [200, 400] * 3
    assert all(len(r["pdbs"]) == 2 for c, r in results if c == 200)
    assert all(r["error"] == "RuntimeError: injected device failure"
               for c, r in results if c == 400)


def test_groups_over_64_rows_run_in_64_row_chunks(server, monkeypatch, capsys):
    state, _ = server
    sizes = []
    real = sampling.euler_sample

    def spy(model, batch, generator, num_steps=100, **kw):
        sizes.append(int(batch["aa"].shape[0]))
        return real(model, batch, generator, num_steps=num_steps, **kw)

    monkeypatch.setattr(sampling, "euler_sample", spy)
    item = serve._build_item({"pocket_pdb": _pdbs(2)[1], "peptide_len": 4})
    groups = state.key_counter
    out = serve._run_group(state, (32, 2), replicate_item(item, 100), [None])
    assert sizes == [64, 64] and len(out) == 100 and state.key_counter == groups + 1
    assert "[serve] group bucket=32 n=100/128 steps=2 " in capsys.readouterr().out
    assert all(_chain_a_residues(r["pdb"]) == 4 for r in out)
    sizes.clear()
    assert len(serve._run_group(state, (32, 2), replicate_item(item, 48), [None])) == 48
    assert sizes == [64] and state.key_counter == groups + 2
    assert "[serve] group bucket=32 n=48/64 steps=2 " in capsys.readouterr().out


def test_loadtest_client_reports_the_jax_tools_keys(server, capsys):
    state, port = server
    out = serve_loadtest.main(["--port", str(port), "--clients", "2", "--requests", "2",
                               "--num_samples", "2", "--num_steps", "2", "--rec_len", "12",
                               "--pep_len", "5", "--timeout", str(TIMEOUT)])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    tree = ast.parse(open(os.path.join(ROOT, "tools", "serve_loadtest.py")).read())
    jax_keys = next(
        [k.value for k in node.value.keys] for node in ast.walk(tree)
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
        and any(isinstance(t, ast.Name) and t.id == "out" for t in node.targets))
    assert list(out) == jax_keys
    assert (out["requests"], out["errors"], out["peptides"]) == (4, 0, 8)
    assert out["peptides_per_sec"] > 0 and set(out["latency_s"]) == {"p50", "p90", "max"}
    assert not torch.cuda.is_initialized()


def test_native_builds_each_library_once_and_counts_under_threads(tmp_path, monkeypatch):
    """Two threads' first kernel calls build each source once (the fake
    compiler writes its -o file after a pause and logs each call), and
    launch counts from many threads add up exactly."""
    log = tmp_path / "calls.log"
    fake = tmp_path / "nvcc"
    fake.write_text(f"#!{sys.executable}\nimport sys, time\n"
                    f"open({str(log)!r}, 'a').write(sys.argv[-1] + '\\n')\ntime.sleep(0.3)\n"
                    "out = sys.argv[sys.argv.index('-o') + 1]\nopen(out, 'w').write('lib')\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(native, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        for f in [ex.submit(native.build_all) for _ in range(2)]:
            f.result(TIMEOUT)
    compiled = sorted(os.path.basename(p)[:-3] for p in log.read_text().split())
    assert compiled == sorted(native.SOURCES)
    assert sorted(os.listdir(tmp_path / "build")) == sorted(
        os.path.basename(native._lib_path(n)) for n in native.SOURCES)

    monkeypatch.setattr(native, "LAUNCHES", dict.fromkeys(native.SOURCES, 0))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with concurrent.futures.ThreadPoolExecutor(16) as ex:
            list(ex.map(lambda _: [native.count_launch("ipa2") for _ in range(2000)], range(16)))
    finally:
        sys.setswitchinterval(interval)
    assert native.LAUNCHES["ipa2"] == 32000
