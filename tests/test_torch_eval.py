"""The port's evaluation path against the JAX package's: the copied tool
wrappers' parsers, gating and command lines (fake tools, in the pattern of
tests/test_evalharness.py), the metrics ``seq_diff_ratio``,
``binding_site_ratio`` and ``summarize_outputs_csv``, and
``python -m pepflowww_torch.evalrun`` against the JAX ``evalrun.py`` on one
tree (in the pattern of tests/test_evalrun.py): floats within 1e-6, the
secondary-structure strings identical.

Inputs: complexes from ``pepflowww_torch.data.synthetic.make_complex``
(numpy seeds), cut into peptide and pocket with the port's
``mask_select_data`` and written with its ``save_pdb``.
"""

import csv
import importlib.util
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

from pepflowww_tpu import evalharness as JE
from pepflowww_tpu import metrics as jax_metrics

from pepflowww_torch import evalharness as E
from pepflowww_torch import evalrun
from pepflowww_torch import metrics
from pepflowww_torch.data.collate import mask_select_data
from pepflowww_torch.data.pdb import save_pdb
from pepflowww_torch.data.synthetic import make_complex

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAKE_PY = ("import sys, json, os\n"
           "with open(os.environ['FAKE_LOG'], 'a') as f:\n"
           "    f.write(json.dumps([os.path.basename(sys.argv[0])] + sys.argv[1:]) + '\\n')\n")
TM_OUT = ("Aligned length=   12, RMSD=   1.23, Seq_ID=n_identical/n_aligned= 0.500\n"
          "TM-score= 0.71234 (if normalized by length of Chain_1)\n"
          "TM-score= 0.69 (if normalized by length of Chain_2)\n")


def _jax_evalrun():
    spec = importlib.util.spec_from_file_location("jax_evalrun", os.path.join(ROOT, "evalrun.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _two_chain_pdb(tmp_path, seed=0):
    path = str(tmp_path / f"complex_{seed}.pdb")
    save_pdb(make_complex(np.random.default_rng(seed), pep_len=5, rec_len=9), path)
    return path


def test_parsers_and_helpers_match_jax(tmp_path, monkeypatch):
    assert E._parse_tm(TM_OUT) == JE._parse_tm(TM_OUT) == {"tm_score": 0.71234, "rmsd": 1.23}
    assert E._parse_tm("nothing") == JE._parse_tm("nothing")
    script = tmp_path / "mkdssp"
    script.write_text("#!/bin/sh\ncat <<'EOT'\n  #  RESIDUE AA STRUCTURE\n"
                      "    1    1 A M  H  ...\n    2    2 A K  E  ...\n    3        !       \n"
                      "    4    3 A L     ...\nEOT\n")
    script.chmod(0o755)
    monkeypatch.setenv("DSSP_PATH", str(script))
    assert E.dssp_assign("x.pdb") == JE.dssp_assign("x.pdb") == "HE-"
    rng = np.random.default_rng(1)
    phi, psi = rng.uniform(-np.pi, np.pi, (2, 200))
    mask = rng.random(200) > 0.1
    ss = E.ramachandran_ss(phi, psi, mask)
    assert ss == JE.ramachandran_ss(phi, psi, mask) and {"H", "E", "C", "-"} == set(ss)
    assert E.ss_recovery(ss, ss[::-1]) == JE.ss_recovery(ss, ss[::-1])
    for seed in range(3):
        pdb = _two_chain_pdb(tmp_path, seed)
        assert E.chain_lengths(pdb) == JE.chain_lengths(pdb) == {"A": 5, "B": 9}
        for chain in "AB":
            assert E.chain_residue_numbers(pdb, chain) == JE.chain_residue_numbers(pdb, chain)
    fasta = tmp_path / "s.fasta"
    fasta.write_text(">s1 one\nACDEF\n>s2\nGHIKL\nMNPQR\n>\nW\n")
    assert E._read_fasta(str(fasta)) == JE._read_fasta(str(fasta))


def test_gating_matches_jax(tmp_path, monkeypatch):
    """With no tool installed, every wrapper of both packages refuses with
    its ToolUnavailable."""
    for var in ("TMALIGN_PATH", "TMSCORE_PATH", "FOLDX_PATH", "SCWRL4_PATH", "DSSP_PATH",
                "ESMIF_RUNNER", "PROTEIN_GENERATOR_PATH", "PROTEINMPNN_PATH", "RFDIFFUSION_PATH"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setitem(sys.modules, "esm", None)
    monkeypatch.setitem(sys.modules, "pyrosetta", None)
    calls = [("tm_align", ("a.pdb", "b.pdb")), ("tm_score", ("a.pdb", "b.pdb")),
             ("foldx_binding_affinity", ("a.pdb",)), ("scwrl4_pack", ("a.pdb", "b.pdb")),
             ("rosetta_energy", ("a.pdb",)), ("run_proteinmpnn", ("a", "b")),
             ("run_esmfold", ("a.fasta", str(tmp_path / "o"))),
             ("run_esmif", ("a.pdb", "b.fasta")), ("run_rfdiffusion", ("a.pdb", "o", 5)),
             ("run_protein_generator", ("a.pdb", "o", 5)), ("dssp_assign", ("a.pdb",))]
    for name, a in calls:
        for mod in (E, JE):
            with pytest.raises(mod.ToolUnavailable):
                getattr(mod, name)(*a)
    monkeypatch.setenv("TMALIGN_PATH", str(tmp_path / "nope"))
    with pytest.raises(E.ToolUnavailable, match="TMALIGN_PATH"):
        E.tm_align("a.pdb", "b.pdb")


def test_wrappers_run_the_same_commands_as_jax(tmp_path, monkeypatch):
    """ProteinMPNN's pipeline, ESM-IF, RFdiffusion and protein_generator
    through fake tools: the same command lines in both packages; ESMFold
    through a fake ``esm`` module: the same PDBs, on the card by default."""
    helpers = tmp_path / "helper_scripts"
    helpers.mkdir()
    for name in ("parse_multiple_chains.py", "assign_fixed_chains.py",
                 "make_fixed_positions_dict.py"):
        (helpers / name).write_text(FAKE_PY)
    for name in ("protein_mpnn_run.py", "sample_sequences.py", "inference.py"):
        (tmp_path / name).write_text(FAKE_PY)
    exe = tmp_path / "run_inference.py"
    exe.write_text("#!/usr/bin/env python3\n" + FAKE_PY)
    exe.chmod(0o755)
    monkeypatch.setenv("PROTEINMPNN_PATH", str(tmp_path / "protein_mpnn_run.py"))
    monkeypatch.setenv("ESMIF_RUNNER", str(tmp_path / "sample_sequences.py"))
    monkeypatch.setenv("PROTEIN_GENERATOR_PATH", str(tmp_path / "inference.py"))
    monkeypatch.setenv("RFDIFFUSION_PATH", str(exe))
    gt = _two_chain_pdb(tmp_path)
    logs = {}
    for tag, mod in (("torch", E), ("jax", JE)):
        log = tmp_path / f"{tag}.jsonl"
        monkeypatch.setenv("FAKE_LOG", str(log))
        mod.run_proteinmpnn(str(tmp_path / "pdbs"), str(tmp_path / "mpnn"), num_seqs=4, gt_pdb=gt)
        mod.run_proteinmpnn(str(tmp_path / "pdbs"), str(tmp_path / "mpnn"), pep_len=6)
        mod.run_esmif("pocket.pdb", str(tmp_path / "esm" / "o.fasta"), num_samples=7,
                      temperature=0.2)
        mod.run_rfdiffusion(gt, str(tmp_path / "rf" / "s"), pep_len=5, num_designs=3)
        mod.run_protein_generator(gt, str(tmp_path / "pg" / "s"), pep_len=5, num_designs=2)
        logs[tag] = [json.loads(line) for line in open(log)]
    assert logs["torch"] == logs["jax"] and len(logs["torch"]) == 11
    assert "contigmap.contigs=[A1-5/0 B1-9/0 5-5]" in logs["torch"][-2]

    devices = []

    class FakeModel:
        def eval(self):
            return self

        def to(self, device):
            devices.append(device)
            return self

        def infer_pdb(self, seq):
            return f"ATOM  fake fold of {seq}\nEND\n"

    fake = types.ModuleType("esm")
    fake.pretrained = types.SimpleNamespace(esmfold_v1=lambda: FakeModel())
    monkeypatch.setitem(sys.modules, "esm", fake)
    monkeypatch.setattr(E, "_ESMFOLD_MODEL", None)
    monkeypatch.setattr(JE, "_ESMFOLD_MODEL", None)
    fasta = tmp_path / "seqs.fasta"
    fasta.write_text(">s1\nACDEF\n>s2\nGHIKL\nMNPQR\n")
    ours = E.run_esmfold(str(fasta), str(tmp_path / "fold_t"))
    theirs = JE.run_esmfold(str(fasta), str(tmp_path / "fold_j"))
    assert [open(p).read() for p in ours] == [open(p).read() for p in theirs]
    assert devices == ["cuda"]


def test_metrics_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    B, L, R = 4, 11, 30
    seq_a, seq_b = rng.integers(0, 20, (2, B, L))
    mask = rng.random((B, L)) > 0.2
    np.testing.assert_allclose(metrics.seq_diff_ratio(seq_a, seq_b, mask),
                               jax_metrics.seq_diff_ratio(seq_a, seq_b, mask), atol=1e-6)
    pep, nat = rng.normal(scale=6.0, size=(2, B, L, 3))
    rec = rng.normal(scale=10.0, size=(B, R, 3))
    rec_mask = rng.random((B, R)) > 0.1
    got = metrics.binding_site_ratio(pep, mask, rec, rec_mask, nat, cutoff=8.0)
    want = jax_metrics.binding_site_ratio(pep, mask, rec, rec_mask, nat, cutoff=8.0)
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert 0.0 < got.min() and got.max() <= 1.0

    path = tmp_path / "outputs.csv"
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["id", "sample", "ca_rmsd", "ca_rmsd_aligned", "aar", "tm_score"])
        for i in range(12):
            w.writerow([f"c{i % 3}", i // 3, *np.round(rng.uniform(0.5, 9.0, 2), 6),
                        round(rng.random(), 6), round(rng.random(), 6)])
    assert metrics.summarize_outputs_csv(str(path)) == jax_metrics.summarize_outputs_csv(str(path))


@pytest.fixture(scope="module")
def sample_tree(tmp_path_factory):
    """Two native complexes, and three samples each: other complexes of the
    same lengths (chain A the peptide, B the pocket)."""
    root = tmp_path_factory.mktemp("evalrun")
    rng = np.random.default_rng(5)
    for i, (pep, rec) in enumerate(((6, 10), (9, 14))):
        cid = f"cplx_{i}"
        item = make_complex(rng, pep_len=pep, rec_len=rec, complex_id=cid)
        os.makedirs(root / "structs" / cid)
        save_pdb(mask_select_data(item, item["generate_mask"]),
                 str(root / "structs" / cid / "peptide.pdb"))
        save_pdb(mask_select_data(item, ~item["generate_mask"]),
                 str(root / "structs" / cid / "pocket.pdb"))
        os.makedirs(root / "samples" / cid)
        for s in range(3):
            other = make_complex(rng, pep_len=pep, rec_len=rec, complex_id=cid)
            save_pdb(other, str(root / "samples" / cid / f"sample_{s}.pdb"))
    return root


def _close(a, b, path=""):
    """Equal structures, floats (and numeric strings) within 1e-6."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, float) or isinstance(b, float):
        assert abs(float(a) - float(b)) <= 1e-6, (path, a, b)
    else:
        assert a == b, (path, a, b)


@pytest.mark.parametrize("mode", ["tool_free", "fake_tmalign"])
def test_evalrun_matches_jax(sample_tree, tmp_path, monkeypatch, mode):
    root = sample_tree
    args = ["--samples_dir", str(root / "samples"), "--structure_dir", str(root / "structs")]
    env = {"PATH": "/usr/bin:/bin", "TMALIGN_PATH": "/nonexistent"}
    if mode == "fake_tmalign":
        fake = tmp_path / "TMalign"
        fake.write_text("#!/bin/sh\necho 'Aligned length=   6, RMSD=   1.50, Seq_ID=n= 1.000'\n"
                        "echo 'TM-score= 0.82000 (if normalized by length of Chain_1)'\n")
        fake.chmod(0o755)
        env["TMALIGN_PATH"] = str(fake)
        args += ["--tools", "tm,ss", "--max_samples", "2"]
    res = subprocess.run([sys.executable, os.path.join(ROOT, "evalrun.py"), *args,
                          "--out", str(tmp_path / "jax")], capture_output=True, text=True,
                         timeout=600, cwd=ROOT, env={**os.environ, **env})
    assert res.returncode == 0, res.stderr[-2000:]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    summary = evalrun.main([*args, "--out", str(tmp_path / "torch")])

    out = {}
    for tag in ("torch", "jax"):
        with open(tmp_path / tag / "eval_outputs.csv", newline="") as f:
            reader = csv.DictReader(f)
            out[tag] = (reader.fieldnames, list(reader),
                        json.load(open(tmp_path / tag / "eval_summary.json")))
    (th, trows, tsum), (jh, jrows, jsum) = out["torch"], out["jax"]
    assert th == jh and len(trows) == len(jrows) == (4 if mode == "fake_tmalign" else 6)
    for a, b in zip(trows, jrows):
        assert set(a) == set(b)
        for k in a:
            if k in ("id", "sample"):
                assert a[k] == b[k]
            else:
                assert abs(float(a[k]) - float(b[k])) <= 1e-6, (k, a[k], b[k])
    _close(tsum, jsum)
    assert summary == tsum
    if mode == "tool_free":
        assert {k for k, v in tsum["tools"].items() if v.startswith("unavailable")} == \
            {"tm", "tmscore", "foldx", "rosetta", "scwrl4"} and tsum["tools"]["ss"] == "ok"
        jrun = _jax_evalrun()
        for cid in ("cplx_0", "cplx_1"):
            for pdb in (root / "structs" / cid / "peptide.pdb",
                        root / "samples" / cid / "sample_0.pdb"):
                assert evalrun.peptide_ss(str(pdb)) == jrun.peptide_ss(str(pdb))
        assert 0.0 <= tsum["means"]["ss_recovery"] < 1.0
    else:
        assert tsum["tools"]["tm"] == "ok"
        assert tsum["tables"]["overall"]["avg_best_rmsd"] == pytest.approx(1.5)
