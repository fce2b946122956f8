"""Evaluation metrics of sampled peptides (counterpart of the JAX package's
``metrics.py``).

The metrics the reference computes online at inference (CA deviation,
rotation Frobenius distance, amino-acid recovery), the geometry metrics
its evaluation harness takes from external tools (RMSD with and without
superposition, TM-score, binding-site overlap, sequence difference), and
the aggregation of the sample CLI's ``outputs.csv``.

Host work: numpy arrays batched over (B, L, ...), masked; the Kabsch
alignment is :func:`pepflowww_torch.ops.frames.kabsch_align` on CPU
tensors. :func:`evaluate_sample` moves a sampler output to the host once.
"""

from __future__ import annotations

import collections
import csv
import statistics

import numpy as np
import torch

from pepflowww_torch.ops.frames import kabsch_align


def _masked_mean(x, mask, axis):
    m = mask.astype(x.dtype)
    return (x * m).sum(axis=axis) / (m.sum(axis=axis) + 1e-8)


def _aligned(pos_a: np.ndarray, pos_b: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """pos_a superposed onto pos_b over the masked points (float32)."""
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
    aligned, _, _ = kabsch_align(t(pos_a), t(pos_b), t(mask))
    return aligned.numpy()


def ca_rmsd(pos_a: np.ndarray, pos_b: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """CA RMSD without superposition: (B,)."""
    sq = np.square(pos_a - pos_b).sum(axis=-1)
    return np.sqrt(_masked_mean(sq, mask, axis=-1))


def ca_rmsd_aligned(pos_a: np.ndarray, pos_b: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """CA RMSD after the Kabsch superposition of a onto b: (B,)."""
    return ca_rmsd(_aligned(pos_a, pos_b, mask), pos_b, mask)


def rotation_frobenius(R_a: np.ndarray, R_b: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """sqrt of the mean ||R_a - R_b||_F² over the masked residues: (B,)."""
    sq = np.square(R_a - R_b).sum(axis=(-1, -2))
    return np.sqrt(_masked_mean(sq, mask, axis=-1))


def amino_acid_recovery(seq_a: np.ndarray, seq_b: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Fraction of matching residues (AAR): (B,)."""
    return _masked_mean((seq_a == seq_b).astype(np.float32), mask, axis=-1)


def seq_diff_ratio(seq_a, seq_b, mask) -> np.ndarray:
    """Fraction of differing residues: 1 - AAR. (B,)."""
    return 1.0 - amino_acid_recovery(seq_a, seq_b, mask)


def tm_score(pos_model: np.ndarray, pos_native: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """TM-score after Kabsch superposition, residue i against residue i:
    d0(L) = 1.24 (L - 15)^(1/3) - 1.8, at least 0.5. (B,)."""
    aligned = _aligned(pos_model, pos_native, mask)
    L = mask.sum(axis=-1)
    d0 = np.maximum(1.24 * np.cbrt(np.maximum(L - 15.0, 1e-6)) - 1.8, 0.5)
    di2 = np.square(aligned - pos_native).sum(axis=-1)
    score = 1.0 / (1.0 + di2 / np.square(d0)[..., None])
    return _masked_mean(score, mask, axis=-1)


def binding_site_ratio(pep_pos: np.ndarray, pep_mask: np.ndarray, rec_pos: np.ndarray,
                       rec_mask: np.ndarray, native_pep_pos: np.ndarray,
                       cutoff: float = 10.0) -> np.ndarray:
    """Share of the native binding site (receptor residues within `cutoff`
    Å of the native peptide) that the generated peptide also lies within
    `cutoff` Å of. Positions are CA, (B, L, 3); (B,)."""

    def site(pp, pm):
        d2 = np.square(rec_pos[:, :, None, :] - pp[:, None, :, :]).sum(-1)
        d2 = np.where(pm[:, None, :], d2, np.inf)
        return (d2 <= cutoff ** 2).any(axis=-1) & rec_mask.astype(bool)

    pm = pep_mask.astype(bool)
    gen_site, nat_site = site(pep_pos, pm), site(native_pep_pos, pm)
    return (gen_site & nat_site).sum(axis=-1) / np.maximum(nat_site.sum(axis=-1), 1)


def evaluate_sample(sample_out: dict, batch: dict) -> dict:
    """Per-sample metrics of one sampler output over its generated rows:
    {ca_rmsd, ca_rmsd_aligned, rot_frobenius, aar, tm_score}, each (B,)."""
    host = lambda x: x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    gen = host(batch["generate_mask"]).astype(bool)
    trans, trans_1 = host(sample_out["trans"]), host(sample_out["trans_1"])
    return {
        "ca_rmsd": ca_rmsd(trans, trans_1, gen),
        "ca_rmsd_aligned": ca_rmsd_aligned(trans, trans_1, gen),
        "rot_frobenius": rotation_frobenius(host(sample_out["rotmats"]),
                                            host(sample_out["rotmats_1"]), gen),
        "aar": amino_acid_recovery(host(sample_out["seqs"]), host(sample_out["seqs_1"]), gen),
        "tm_score": tm_score(trans, trans_1, gen),
    }


def summarize_outputs(rows: list) -> dict:
    """Aggregate per-sample metric rows ({id, ca_rmsd_aligned or ca_rmsd,
    aar, ...}; every other numeric column too) into
    {"per_complex": {id: {n, best_rmsd, median_rmsd, mean_<col>, ...}},
     "overall": {num_complexes, avg_<stat>, success_rate_2A, success_rate_5A}}.
    The success rates are the shares of complexes whose best sample lies
    under 2 Å and 5 Å aligned CA RMSD. Each column is aggregated over the
    rows that have it."""
    by_id = collections.defaultdict(list)
    for r in rows:
        by_id[r["id"]].append(r)
    rmsd_key = "ca_rmsd_aligned" if any("ca_rmsd_aligned" in r for r in rows) else "ca_rmsd"
    per_complex = {}
    for cid, rs in by_id.items():
        rmsds = [float(r[rmsd_key]) for r in rs if r.get(rmsd_key) is not None]
        entry = {"n": len(rs)}
        if rmsds:
            entry["best_rmsd"] = min(rmsds)
            entry["median_rmsd"] = statistics.median(rmsds)
        for key in sorted(set().union(*(set(r) for r in rs))):
            if key in ("id", "sample", rmsd_key):
                continue
            vals = []
            for r in rs:
                try:
                    v = r.get(key)
                    if v is not None:
                        vals.append(float(v))
                except (TypeError, ValueError):
                    vals = []
                    break
            if not vals:
                continue
            entry[f"mean_{key}"] = statistics.fmean(vals)
            if key == "tm_score":
                entry["best_tm"] = max(vals)
        per_complex[cid] = entry

    n = len(per_complex)
    overall = {"num_complexes": n}
    if n:
        for key in sorted(set().union(*(set(v) for v in per_complex.values())) - {"n"}):
            overall[f"avg_{key}"] = statistics.fmean(
                [v[key] for v in per_complex.values() if key in v])
        for cut in (2, 5):
            overall[f"success_rate_{cut}A"] = sum(
                v.get("best_rmsd", float("inf")) < cut for v in per_complex.values()) / n
    return {"per_complex": per_complex, "overall": overall}


def summarize_outputs_csv(path: str) -> dict:
    """:func:`summarize_outputs` over an ``outputs.csv``."""
    with open(path, newline="") as f:
        return summarize_outputs(list(csv.DictReader(f)))
