"""Evaluation CLI over a sample CLI's results directory (the port's copy of
the JAX package's ``evalrun.py``).

    python -m pepflowww_torch.evalrun --samples_dir results/ \
        --structure_dir structs_test/ [--tools tm,foldx,rosetta,ss] \
        [--max_samples 8] [--max_complexes N] [--out results/eval]

Walks ``<samples_dir>/<id>/sample_*.pdb``, scores each generated complex
against the native ``<structure_dir>/<id>/{peptide.pdb,pocket.pdb}`` with
the wrappers of :mod:`pepflowww_torch.evalharness`, and aggregates the
paper tables (:func:`pepflowww_torch.metrics.summarize_outputs`). Tools
resolve as the wrappers do (PATH or ``*_PATH`` variables). A tool that is
absent is recorded as unavailable in the summary and skipped; any other
failure is counted per sample, and five in a row disable the tool. The
secondary-structure recovery (``ss``) uses mkdssp where it is installed
and the Ramachandran assignment of the backbone dihedrals (computed on the
CPU) where not, so it runs without any external tool.

Writes ``<out>/eval_outputs.csv`` (one row a sample, with the metrics that
ran) and ``<out>/eval_summary.json`` (the tools' status, error counts, and
the tables, or plain means where no RMSD column exists).
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import tempfile

import numpy as np

ALL_TOOLS = ("tm", "tmscore", "foldx", "rosetta", "ss", "scwrl4")
MAX_CONSECUTIVE_FAILS = 5


def extract_chain(pdb_path: str, chain_id: str, out_path: str) -> str:
    """Write only the ATOM/HETATM/TER records of one chain."""
    with open(pdb_path) as f, open(out_path, "w") as g:
        for line in f:
            if line.startswith(("ATOM", "HETATM", "TER")) and len(line) > 21:
                if line[21] == chain_id:
                    g.write(line)
        g.write("END\n")
    return out_path


def peptide_ss(pdb_path: str) -> str:
    """Secondary structure of a structure's residues: mkdssp where it is
    installed, else the Ramachandran assignment of its backbone dihedrals."""
    import torch

    from pepflowww_torch import evalharness as E
    from pepflowww_torch.data.pdb import parse_pdb
    from pepflowww_torch.ops import dihedrals

    try:
        ss = E.dssp_assign(pdb_path)
        if ss:
            return ss
    except E.ToolUnavailable:
        pass
    data, _ = parse_pdb(pdb_path)
    if data is None:
        return ""
    with torch.no_grad():
        bb, bb_mask = dihedrals.get_backbone_dihedral_angles(
            torch.from_numpy(data["pos_heavyatom"])[None],
            torch.from_numpy(data["chain_nb"])[None],
            torch.from_numpy(data["res_nb"])[None],
            torch.from_numpy(data["mask_heavyatom"][:, 1])[None])   # CA mask
    bb, bb_mask = bb[0].numpy(), bb_mask[0].numpy()
    return "".join(E.ramachandran_ss(bb[:, 1], bb[:, 2], bb_mask[:, 1] & bb_mask[:, 2]))


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--samples_dir", required=True,
                    help="the sample CLI's --out directory (<id>/sample_*.pdb)")
    ap.add_argument("--structure_dir", required=True,
                    help="native structures (<id>/{peptide.pdb,pocket.pdb})")
    ap.add_argument("--out", default=None, help="default <samples_dir>/eval")
    ap.add_argument("--tools", default="auto",
                    help=f"comma list of {','.join(ALL_TOOLS)}; 'auto' = all, "
                         "each skipped when its binary is absent")
    ap.add_argument("--max_samples", type=int, default=None,
                    help="cap on the samples scored a complex")
    ap.add_argument("--max_complexes", type=int, default=None)
    return ap


def main(argv=None) -> dict:
    """Runs the CLI; returns the summary it writes."""
    from pepflowww_torch import evalharness as E
    from pepflowww_torch.metrics import summarize_outputs

    args = _parser().parse_args(argv)
    tools = ALL_TOOLS if args.tools == "auto" else tuple(
        t.strip() for t in args.tools.split(",") if t.strip())
    unknown = set(tools) - set(ALL_TOOLS)
    if unknown:
        raise SystemExit(f"unknown tools: {sorted(unknown)}")
    out_dir = args.out or os.path.join(args.samples_dir, "eval")
    os.makedirs(out_dir, exist_ok=True)

    complexes = sorted(d for d in os.listdir(args.samples_dir)
                       if os.path.isdir(os.path.join(args.samples_dir, d))
                       and d != os.path.basename(out_dir.rstrip("/")))
    if args.max_complexes:
        complexes = complexes[:args.max_complexes]

    rows = []
    tool_status = {t: "ok" for t in tools}
    tool_errors = {t: 0 for t in tools}
    consecutive_fails = {t: 0 for t in tools}

    def guarded(tool, fn, *a, **kw):
        """One wrapper call. ToolUnavailable disables the tool for the rest
        of the sweep; any other failure is counted for this sample, and
        MAX_CONSECUTIVE_FAILS in a row disable the tool."""
        if tool_status.get(tool, "skipped") != "ok":
            return None
        try:
            out = fn(*a, **kw)
            consecutive_fails[tool] = 0
            return out
        except E.ToolUnavailable as e:
            tool_status[tool] = f"unavailable: {e}"
            return None
        except Exception as e:  # noqa: BLE001 - recorded, the sweep goes on
            tool_errors[tool] += 1
            consecutive_fails[tool] += 1
            print(f"[evalrun] {tool} failed on one sample "
                  f"({e.__class__.__name__}: {e}); continuing")
            if consecutive_fails[tool] >= MAX_CONSECUTIVE_FAILS:
                tool_status[tool] = (f"disabled after {MAX_CONSECUTIVE_FAILS} consecutive "
                                     f"failures (last: {e.__class__.__name__}: {e})")
            return None

    with tempfile.TemporaryDirectory() as tmp:
        for cid in complexes:
            native_pep = os.path.join(args.structure_dir, cid, "peptide.pdb")
            if not os.path.exists(native_pep):
                print(f"[evalrun] {cid}: no native peptide, skipped")
                continue
            native_ss = peptide_ss(native_pep) if "ss" in tools else None
            cdir = os.path.join(args.samples_dir, cid)
            samples = sorted(f for f in os.listdir(cdir)
                             if f.startswith("sample_") and f.endswith(".pdb"))
            if args.max_samples:
                samples = samples[:args.max_samples]
            for s in samples:
                sample_pdb = os.path.join(cdir, s)
                model_pep = extract_chain(sample_pdb, "A", os.path.join(tmp, "model_pep.pdb"))
                row = {"id": cid, "sample": s}
                if "tm" in tools:
                    r = guarded("tm", E.tm_align, model_pep, native_pep)
                    if r:
                        row["tm_score"] = r.get("tm_score")
                        row["ca_rmsd_aligned"] = r.get("rmsd")
                if "tmscore" in tools:
                    r = guarded("tmscore", E.tm_score, model_pep, native_pep)
                    if r:
                        row["tmscore"] = r.get("tm_score")
                if "foldx" in tools:
                    r = guarded("foldx", E.foldx_binding_affinity, sample_pdb)
                    if r is not None:
                        row["foldx_affinity"] = r
                if "rosetta" in tools:
                    r = guarded("rosetta", E.rosetta_energy, sample_pdb)
                    if r:
                        row.update({f"rosetta_{k}": v for k, v in r.items()})
                if "scwrl4" in tools:
                    r = guarded("scwrl4", E.scwrl4_pack, model_pep,
                                os.path.join(tmp, "packed.pdb"))
                    if r is not None:
                        row["scwrl4_packed"] = 1.0
                if "ss" in tools and native_ss:
                    row["ss_recovery"] = E.ss_recovery(peptide_ss(model_pep), native_ss)
                rows.append(row)
            done = [k for k in rows[-1] if k not in ("id", "sample")] if rows else []
            print(f"[evalrun] {cid}: {len(samples)} samples, metrics={done}")

    csv_path = os.path.join(out_dir, "eval_outputs.csv")
    fieldnames = sorted({k for r in rows for k in r},
                        key=lambda k: (k not in ("id", "sample"), k))
    with open(csv_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fieldnames)
        w.writeheader()
        w.writerows(rows)

    metric_rows = [r for r in rows if len(r) > 2]
    summary = {"tools": tool_status,
               "tool_error_counts": {t: n for t, n in tool_errors.items() if n},
               "num_rows": len(rows)}
    if metric_rows and any("ca_rmsd_aligned" in r or "ca_rmsd" in r for r in metric_rows):
        summary["tables"] = summarize_outputs(metric_rows)
    elif metric_rows:
        # no RMSD column (TMalign absent): plain means
        keys = sorted({k for r in metric_rows for k in r} - {"id", "sample"})
        summary["means"] = {k: float(np.mean([r[k] for r in metric_rows if k in r]))
                            for k in keys}
    with open(os.path.join(out_dir, "eval_summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(f"[evalrun] wrote {csv_path} and eval_summary.json; tools: "
          + ", ".join(f"{k}={v.split(':')[0]}" for k, v in tool_status.items()))
    return summary


if __name__ == "__main__":
    main()
