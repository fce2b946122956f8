"""External-tool evaluation harness (device-independent, subprocess-based;
the port's copy of the JAX package's ``evalharness.py``, on the port's own
PDB parser).

Re-designs the reference's `eval/` scripts as one module of gated
wrappers: each function checks for its binary/package and raises
`ToolUnavailable` with a clear message when absent, instead of hard-coding
cluster paths the way the reference does (e.g. eval/align.py:7,
eval/foldx.py:69, eval/run_mpnn.py:17).

Covered tools and their reference scripts:
    TMalign / TMscore       eval/align.py
    FoldX AnalyseComplex    eval/foldx.py
    Scwrl4                  eval/run_scwrl4.py
    PyRosetta relax/dG      eval/energy.py
    ProteinMPNN             eval/run_mpnn.py
    ESMFold                 eval/run_esmfold.py
    ESM-IF                  eval/run_esmif.py
    RFdiffusion             eval/run_rfdiffusion.py
    DSSP (mkdssp)           eval/geometry.py:79-91 (+ pepflow/modules/protein/dssp.py)

A pure-Python Ramachandran-region secondary-structure assigner is provided as
a DSSP fallback so SS-recovery is computable without mkdssp.
"""

from __future__ import annotations

import os
import re
import shutil
import subprocess
import sys
from typing import Optional, Sequence

import numpy as np


class ToolUnavailable(RuntimeError):
    pass


def _find(binary: str, env_var: str) -> str:
    path = os.environ.get(env_var) or shutil.which(binary)
    if not path or not os.path.exists(path) and not shutil.which(path):
        raise ToolUnavailable(
            f"{binary} not found; install it or set ${env_var} to its path"
        )
    return path


# ---------------------------------------------------------------- TM tools
def tm_align(pdb_model: str, pdb_native: str) -> dict:
    """TMalign two structures; returns {'tm_score', 'rmsd'} (eval/align.py)."""
    exe = _find("TMalign", "TMALIGN_PATH")
    out = subprocess.run([exe, pdb_model, pdb_native], capture_output=True, text=True).stdout
    return _parse_tm(out)


def tm_score(pdb_model: str, pdb_native: str) -> dict:
    exe = _find("TMscore", "TMSCORE_PATH")
    out = subprocess.run([exe, pdb_model, pdb_native], capture_output=True, text=True).stdout
    return _parse_tm(out)


def _parse_tm(out: str) -> dict:
    tm = None
    rmsd = None
    for line in out.splitlines():
        m = re.match(r"^TM-score\s*=\s*([\d.]+)", line)
        if m and tm is None:
            tm = float(m.group(1))
        m = re.search(r"RMSD[^=]*=\s*([\d.]+)", line)
        if m and rmsd is None:
            rmsd = float(m.group(1))
    return {"tm_score": tm, "rmsd": rmsd}


# ---------------------------------------------------------------- FoldX
def foldx_binding_affinity(pdb_path: str, workdir: Optional[str] = None) -> float:
    """FoldX AnalyseComplex interaction energy (eval/foldx.py:69-76)."""
    exe = _find("foldx", "FOLDX_PATH")
    workdir = workdir or os.path.dirname(os.path.abspath(pdb_path))
    name = os.path.basename(pdb_path)
    subprocess.run(
        [exe, "--command=AnalyseComplex", f"--pdb={name}"],
        cwd=workdir, capture_output=True, text=True,
    )
    summary = os.path.join(workdir, f"Summary_{name.replace('.pdb', '')}_AC.fxout")
    if not os.path.exists(summary):
        raise ToolUnavailable("FoldX did not produce a summary file")
    with open(summary) as f:
        lines = [l for l in f if l.strip()]
    return float(lines[-1].split("\t")[5])


# ---------------------------------------------------------------- Scwrl4
def scwrl4_pack(pdb_in: str, pdb_out: str) -> str:
    """Side-chain repacking baseline (eval/run_scwrl4.py:15-29)."""
    exe = _find("Scwrl4", "SCWRL4_PATH")
    subprocess.run([exe, "-i", pdb_in, "-o", pdb_out], capture_output=True, text=True)
    if not os.path.exists(pdb_out):
        raise ToolUnavailable("Scwrl4 produced no output")
    return pdb_out


# ---------------------------------------------------------------- PyRosetta
def rosetta_energy(pdb_path: str, n_repeats: int = 5) -> dict:
    """FastRelax stability + InterfaceAnalyzer dG (eval/energy.py:33-55)."""
    try:
        import pyrosetta  # type: ignore
        from pyrosetta.rosetta.protocols.analysis import InterfaceAnalyzerMover  # type: ignore
        from pyrosetta.rosetta.protocols.relax import FastRelax  # type: ignore
    except ImportError as e:
        raise ToolUnavailable("pyrosetta not installed") from e

    pyrosetta.init(extra_options="-mute all")
    sfxn = pyrosetta.get_fa_scorefxn()
    stabilities, dgs = [], []
    for _ in range(n_repeats):
        pose = pyrosetta.pose_from_pdb(pdb_path)
        relax = FastRelax()
        relax.set_scorefxn(sfxn)
        relax.apply(pose)
        stabilities.append(sfxn(pose))
        iam = InterfaceAnalyzerMover()
        iam.apply(pose)
        dgs.append(iam.get_interface_dG())
    return {"stability": float(np.mean(stabilities)), "dG_separated": float(np.mean(dgs))}


# ---------------------------------------------------------------- helpers
def chain_lengths(pdb_path: str) -> dict:
    """{chain_id: number of CA-bearing residues}, insertion-ordered
    (eval/utils.py:81-91 `get_chain_dic`, without Biopython)."""
    from pepflowww_torch import constants as C
    from pepflowww_torch.data.pdb import parse_pdb

    data, _ = parse_pdb(pdb_path)
    if data is None:
        raise ValueError(f"no parsable residues in {pdb_path}")
    out: dict = {}
    has_ca = np.asarray(data["mask_heavyatom"])[:, C.BBHeavyAtom.CA]
    for cid, ok in zip(data["chain_id"], has_ca):
        out[cid] = out.get(cid, 0) + int(ok)
    return out


def chain_residue_numbers(pdb_path: str, chain_id: str) -> list:
    """Residue numbers of one chain (eval/run_mpnn.py:20-24 `get_chain_nums`)."""
    from pepflowww_torch.data.pdb import parse_pdb

    data, _ = parse_pdb(pdb_path)
    if data is None:
        raise ValueError(f"no parsable residues in {pdb_path}")
    return [int(n) for cid, n in zip(data["chain_id"], data["resseq"]) if cid == chain_id]


def _read_fasta(path: str) -> list:
    """[(name, sequence)] pairs from a fasta file."""
    out, name, seq = [], None, []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith(">"):
                if name is not None:
                    out.append((name, "".join(seq)))
                name, seq = line[1:].split()[0] if len(line) > 1 else "seq", []
            elif line:
                seq.append(line)
    if name is not None:
        out.append((name, "".join(seq)))
    return out


# ---------------------------------------------------------------- baselines
def run_proteinmpnn(
    pdb_dir: str,
    out_dir: str,
    chains_to_design: str = "A",
    num_seqs: int = 1,
    design_positions: Optional[Sequence[int]] = None,
    gt_pdb: Optional[str] = None,
    pep_len: Optional[int] = None,
    sampling_temp: float = 0.1,
    seed: int = 37,
    batch_size: int = 1,
) -> str:
    """Receptor-fixed peptide redesign via the ProteinMPNN fixed-positions
    pipeline (eval/run_mpnn.py:26-71): parse_multiple_chains ->
    assign_fixed_chains -> make_fixed_positions_dict (--specify_non_fixed
    over the peptide residue numbers) -> protein_mpnn_run.

    `design_positions` are the residue numbers that MAY be redesigned (the
    peptide); everything else is fixed. If absent they are read from
    `gt_pdb`'s design chain (run_mpnn.py:36) or derived as 1..pep_len
    (run_mpnn.py:85-88 uses the fasta length); with none of the three, the
    fixed-positions step is skipped and the whole design chain is redesigned.
    """
    runner = os.environ.get("PROTEINMPNN_PATH")
    if not runner or not os.path.exists(runner):
        raise ToolUnavailable("set $PROTEINMPNN_PATH to protein_mpnn_run.py")
    helpers = os.environ.get("PROTEINMPNN_HELPERS") or os.path.join(
        os.path.dirname(runner), "helper_scripts"
    )
    if not os.path.isdir(helpers):
        raise ToolUnavailable(
            "set $PROTEINMPNN_HELPERS to ProteinMPNN's helper_scripts dir"
        )
    os.makedirs(out_dir, exist_ok=True)
    parsed = os.path.join(out_dir, "parsed_pdbs.jsonl")
    assigned = os.path.join(out_dir, "assigned_pdbs.jsonl")
    fixed = os.path.join(out_dir, "fixed_pdbs.jsonl")

    if design_positions is None:
        if gt_pdb is not None:
            design_positions = chain_residue_numbers(gt_pdb, chains_to_design)
        elif pep_len is not None:
            design_positions = list(range(1, pep_len + 1))

    subprocess.run(
        [sys.executable, os.path.join(helpers, "parse_multiple_chains.py"),
         "--input_path", pdb_dir, "--output_path", parsed],
        check=True,
    )
    subprocess.run(
        [sys.executable, os.path.join(helpers, "assign_fixed_chains.py"),
         "--input_path", parsed, "--output_path", assigned,
         "--chain_list", chains_to_design],
        check=True,
    )
    cmd = [sys.executable, runner,
           "--jsonl_path", parsed,
           "--chain_id_jsonl", assigned,
           "--out_folder", out_dir,
           "--num_seq_per_target", str(num_seqs),
           "--sampling_temp", str(sampling_temp),
           "--seed", str(seed),
           "--batch_size", str(batch_size)]
    if design_positions is not None:
        subprocess.run(
            [sys.executable, os.path.join(helpers, "make_fixed_positions_dict.py"),
             "--input_path", parsed, "--output_path", fixed,
             "--chain_list", chains_to_design,
             "--position_list", " ".join(map(str, design_positions)),
             "--specify_non_fixed"],
            check=True,
        )
        cmd += ["--fixed_positions_jsonl", fixed]
    subprocess.run(cmd, check=True)
    return out_dir


_ESMFOLD_MODEL = None
_ESMFOLD_DEVICE = None


def run_esmfold(fasta_path: str, out_dir: str, device: Optional[str] = "cuda") -> list:
    """Refold sequences for designability (eval/run_esmfold.py:23-45):
    ESMFold v1 `infer_pdb` per fasta record -> `<out_dir>/<name>.pdb`.

    The model loads once per process (the reference loads at module import,
    run_esmfold.py:23-24) and runs on the card unless `device` names another
    device; `device=None` leaves the cached model where it is (the CPU on
    first load). Returns the list of written PDB paths.
    """
    try:
        import esm  # type: ignore
    except ImportError as e:
        raise ToolUnavailable("fair-esm not installed") from e
    import torch

    global _ESMFOLD_MODEL, _ESMFOLD_DEVICE
    if _ESMFOLD_MODEL is None:
        _ESMFOLD_MODEL = esm.pretrained.esmfold_v1().eval()
        _ESMFOLD_DEVICE = None
    if device and device != _ESMFOLD_DEVICE:
        _ESMFOLD_MODEL = _ESMFOLD_MODEL.to(device)
        _ESMFOLD_DEVICE = device

    os.makedirs(out_dir, exist_ok=True)
    written = []
    for name, seq in _read_fasta(fasta_path):
        with torch.no_grad():
            pdb_str = _ESMFOLD_MODEL.infer_pdb(seq)
        path = os.path.join(out_dir, f"{name}.pdb")
        with open(path, "w") as f:
            f.write(pdb_str)
        written.append(path)
    return written


def run_esmif(
    pdb_path: str,
    out_fasta: str,
    chain: str = "A",
    num_samples: int = 10,
    temperature: float = 0.1,
) -> str:
    """ESM-IF inverse-folding baseline (eval/run_esmif.py:17-33): drives
    esm's examples/inverse_folding/sample_sequences.py with the reference's
    argument surface (--multichain-backbone --nogpu)."""
    runner = os.environ.get("ESMIF_RUNNER")
    if not runner or not os.path.exists(runner):
        raise ToolUnavailable(
            "set $ESMIF_RUNNER to esm/examples/inverse_folding/sample_sequences.py"
        )
    out_parent = os.path.dirname(os.path.abspath(out_fasta))
    os.makedirs(out_parent, exist_ok=True)
    subprocess.run(
        [sys.executable, runner, pdb_path,
         "--chain", chain,
         "--temperature", str(temperature),
         "--num-samples", str(num_samples),
         "--outpath", out_fasta,
         "--multichain-backbone", "--nogpu"],
        check=True,
    )
    return out_fasta


def run_rfdiffusion(
    pocket_pdb: str,
    out_prefix: str,
    pep_len: int,
    num_designs: int = 10,
) -> str:
    """RFdiffusion structure-generation baseline (eval/run_rfdiffusion.py:19-42):
    contigs keep every pocket chain fixed (`<chain>1-<len>/0`) and append a
    free `<pep_len>-<pep_len>` segment for the peptide."""
    exe = _find("run_inference.py", "RFDIFFUSION_PATH")
    chain_dic = chain_lengths(pocket_pdb)
    contigs = " ".join(
        [f"{c}1-{n}/0" for c, n in chain_dic.items()] + [f"{pep_len}-{pep_len}"]
    )
    os.makedirs(os.path.dirname(os.path.abspath(out_prefix)), exist_ok=True)
    subprocess.run(
        [exe,
         f"inference.output_prefix='{out_prefix}'",
         f"inference.input_pdb='{pocket_pdb}'",
         f"contigmap.contigs=[{contigs}]",
         f"inference.num_designs={num_designs}"],
        check=True,
    )
    return out_prefix


def run_protein_generator(
    pocket_pdb: str,
    out_prefix: str,
    pep_len: int,
    num_designs: int = 10,
    T: int = 25,
) -> str:
    """protein_generator co-design baseline (eval/run_rfdiffusion.py:45-70);
    contig separator is `,0` in this tool's dialect."""
    script = os.environ.get("PROTEIN_GENERATOR_PATH")
    if not script or not os.path.exists(script):
        raise ToolUnavailable("set $PROTEIN_GENERATOR_PATH to protein_generator/inference.py")
    chain_dic = chain_lengths(pocket_pdb)
    contigs = [f"{c}1-{n},0" for c, n in chain_dic.items()] + [f"{pep_len}-{pep_len}"]
    os.makedirs(os.path.dirname(os.path.abspath(out_prefix)), exist_ok=True)
    subprocess.run(
        [sys.executable, script,
         "--num_designs", str(num_designs),
         "--out", out_prefix,
         "--pdb", pocket_pdb,
         "--T", str(T),
         "--save_best_plddt",
         "--contigs", *contigs],
        check=True,
    )
    return out_prefix


# ---------------------------------------------------------------- DSSP
def dssp_assign(pdb_path: str) -> str:
    """Secondary structure string via mkdssp (eval/geometry.py:79-91)."""
    exe = _find("mkdssp", "DSSP_PATH")
    out = subprocess.run([exe, pdb_path], capture_output=True, text=True).stdout
    ss = []
    started = False
    for line in out.splitlines():
        if line.startswith("  #  RESIDUE"):
            started = True
            continue
        if started and len(line) > 16 and line[13] != "!":
            ss.append(line[16] if line[16] != " " else "-")
    return "".join(ss)


def ramachandran_ss(phi: np.ndarray, psi: np.ndarray, mask: np.ndarray) -> list[str]:
    """DSSP-free 3-state secondary structure from backbone dihedrals.

    Region boundaries follow the classic Ramachandran partition: H (alpha),
    E (beta), C (coil). A fallback for SS-recovery when mkdssp is absent.
    """
    out = []
    phi_d, psi_d = np.degrees(phi), np.degrees(psi)
    for p, s, m in zip(phi_d.ravel(), psi_d.ravel(), np.asarray(mask).ravel()):
        if not m:
            out.append("-")
        elif -160.0 < p < -20.0 and -120.0 < s < 50.0:
            out.append("H")
        elif -180.0 <= p < -20.0 and (s > 90.0 or s < -150.0):
            out.append("E")
        else:
            out.append("C")
    return out


def ss_recovery(ss_a, ss_b) -> float:
    """Fraction of matching SS states over aligned residues."""
    pairs = [(a, b) for a, b in zip(ss_a, ss_b) if a != "-" and b != "-"]
    if not pairs:
        return 0.0
    return sum(a == b for a, b in pairs) / len(pairs)
