"""Synthetic peptide–pocket complexes for tests, the sample CLI and the chip
smoke run (counterpart of ``make_complex`` / ``make_batch`` in the JAX
package's ``data/synthetic.py``), and PepMerge-style structure directories
of them (counterpart of ``tools/make_synthetic_structures.py``):

    python -m pepflowww_torch.data.synthetic --out DIR [--n 40] [--seed 0] \
        [--min_rec 15] [--max_rec 110]

writes ``DIR/synth_<i>/{peptide.pdb,pocket.pdb}`` with peptides of 3-25
residues and pockets of ``min_rec``-``max_rec``, drawn in the JAX tool's
order from one numpy generator.

Random backbone frames and valid torsions go through the package's own
full-atom reconstruction (float32, on the CPU); the schema is the
preprocessed item's: receptor first (chain_nb 1), peptide last (chain_nb 0,
``generate_mask``), positions centered on the peptide CA centroid. The same
numpy generator state gives the same complex as the JAX package, up to
float32 rounding in the reconstruction.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch

from pepflowww_torch import constants as C
from pepflowww_torch.data.collate import pad_and_collate
from pepflowww_torch.data.pdb import save_pdb
from pepflowww_torch.ops import allatom


def _random_rotmats(rng: np.random.Generator, shape):
    q = rng.normal(size=tuple(shape) + (4,))
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        np.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], axis=-2)
    return R.astype(np.float32)


def make_complex(rng: np.random.Generator, pep_len: int = 12, rec_len: int = 40,
                 complex_id: str = "synth") -> dict:
    """One synthetic complex in the preprocessed-item schema (numpy)."""
    L = rec_len + pep_len
    aa = rng.integers(0, 20, size=(L,)).astype(np.int64)
    steps = rng.normal(scale=1.5, size=(L, 3)).astype(np.float32)
    t = np.cumsum(steps + np.array([3.8, 0, 0], dtype=np.float32), axis=0)
    R = _random_rotmats(rng, (L,))
    angles = rng.uniform(0, 2 * np.pi, size=(L, 5)).astype(np.float32)
    angles = angles * C.TORSIONS_MASK[aa]

    with torch.no_grad():
        pos14, _, _ = allatom.full_atom_reconstruction(
            torch.from_numpy(R)[None], torch.from_numpy(t)[None],
            torch.from_numpy(angles)[None], torch.from_numpy(aa)[None])
        pos15 = allatom.full_atom_to_pos15(pos14)[0].numpy().astype(np.float32)

    center = pos15[rec_len:, C.BBHeavyAtom.CA].mean(axis=0)
    pos15 = pos15 - center[None, None, :]
    mask15 = C.HEAVYATOM_MASK_GEN[aa].copy()
    with torch.no_grad():
        tor, tor_mask = allatom.get_torsion_angles(torch.from_numpy(pos15)[None],
                                                   torch.from_numpy(aa)[None])
    chain_nb = np.concatenate([np.ones(rec_len, dtype=np.int64), np.zeros(pep_len, dtype=np.int64)])
    res_nb = np.concatenate([np.arange(1, rec_len + 1, dtype=np.int64),
                             np.arange(1, pep_len + 1, dtype=np.int64)])
    return {
        "id": complex_id,
        "aa": aa,
        "pos_heavyatom": pos15,
        "mask_heavyatom": mask15,
        "chain_nb": chain_nb,
        "chain_id": ["B"] * rec_len + ["A"] * pep_len,
        "res_nb": res_nb,
        "resseq": res_nb.copy(),
        "icode": [" "] * L,
        "generate_mask": np.concatenate([np.zeros(rec_len, dtype=bool), np.ones(pep_len, dtype=bool)]),
        "torsion_angle": tor[0].numpy().astype(np.float32),
        "torsion_angle_mask": tor_mask[0].numpy(),
    }


def make_batch(rng: np.random.Generator, batch_size: int = 4, pep_len: int = 12,
               rec_len: int = 40, pad_to: int | None = None) -> dict:
    """A padded numpy batch of `batch_size` independent synthetic complexes."""
    items = [make_complex(rng, pep_len=pep_len, rec_len=rec_len, complex_id=f"synth{i}")
             for i in range(batch_size)]
    return pad_and_collate(items, pad_to=pad_to)


def write_complex_pdbs(item: dict, cdir: str) -> None:
    """`item`'s peptide (generated rows) as ``cdir/peptide.pdb`` and its
    pocket as ``cdir/pocket.pdb``."""
    os.makedirs(cdir, exist_ok=True)
    sel = np.asarray(item["generate_mask"])
    skip = ("id", "generate_mask", "torsion_angle", "torsion_angle_mask")

    def subset(keep):
        return {k: (v[keep] if isinstance(v, np.ndarray) else [x for x, s in zip(v, keep) if s])
                for k, v in item.items() if k not in skip}

    save_pdb(subset(sel), os.path.join(cdir, "peptide.pdb"))
    save_pdb(subset(~sel), os.path.join(cdir, "pocket.pdb"))


def write_structure_dir(out: str, n: int = 40, seed: int = 0, min_rec: int = 15,
                        max_rec: int = 110,
                        sizes: Optional[Sequence[tuple]] = None) -> list:
    """Write ``out/synth_<i>/{peptide.pdb,pocket.pdb}`` for `n` synthetic
    complexes, or for one complex per (pep_len, rec_len) of `sizes`; returns
    the ids. Without `sizes` the lengths are drawn as the JAX package's tool
    draws them (peptide 3-25, pocket `min_rec`-`max_rec`)."""
    os.makedirs(out, exist_ok=True)
    rng = np.random.default_rng(seed)
    ids = []
    for i in range(n if sizes is None else len(sizes)):
        if sizes is None:
            pep_len = int(rng.integers(3, 26))
            rec_len = int(rng.integers(min_rec, max_rec + 1))
        else:
            pep_len, rec_len = sizes[i]
        cid = f"synth_{i:04d}"
        write_complex_pdbs(make_complex(rng, pep_len=pep_len, rec_len=rec_len, complex_id=cid),
                           os.path.join(out, cid))
        ids.append(cid)
    return ids


def main(argv=None):
    ap = argparse.ArgumentParser(description="Write a PepMerge-style structure directory "
                                             "of synthetic complexes.")
    ap.add_argument("--out", required=True)
    ap.add_argument("--n", type=int, default=40)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--min_rec", type=int, default=15)
    ap.add_argument("--max_rec", type=int, default=110)
    args = ap.parse_args(argv)
    write_structure_dir(args.out, args.n, args.seed, args.min_rec, args.max_rec)
    print(f"wrote {args.n} complexes under {args.out}")


if __name__ == "__main__":
    main()
