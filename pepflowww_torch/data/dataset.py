"""PepMerge-style peptide–pocket dataset: preprocessing and the cache
(counterpart of ``preprocess_structure`` and ``PepDataset`` in the JAX
package's ``data/dataset.py``).

* each complex lives in ``<structure_dir>/<id>/{peptide.pdb,pocket.pdb}``;
* both structures are centered on the peptide's CA centroid, and the
  torsions are taken after centering;
* the peptide's length must lie in [3, 25]; the receptor's chain_nb is
  shifted by one;
* an item is receptor ‖ peptide, with ``generate_mask`` marking the
  peptide.

The cache is a :class:`~pepflowww_torch.data.recordstore.RecordStore`,
byte-compatible with the JAX package's. Preprocessing is host work: the
torsions come from :func:`pepflowww_torch.ops.allatom.get_torsion_angles`
on the CPU, and the complexes fan out over a process pool started with
``spawn`` (a caller may hold a CUDA context, which a forked child must not
inherit).
"""

from __future__ import annotations

import concurrent.futures
import logging
import multiprocessing
import os
from typing import Optional

import numpy as np

from pepflowww_torch import constants as C
from pepflowww_torch.data import recordstore
from pepflowww_torch.data.pdb import parse_pdb

logger = logging.getLogger(__name__)


def _torsions(pos15: np.ndarray, aa: np.ndarray):
    import torch

    from pepflowww_torch.ops import allatom

    with torch.no_grad():
        tor, mask = allatom.get_torsion_angles(torch.from_numpy(pos15)[None],
                                               torch.from_numpy(aa)[None])
    return tor[0].numpy().astype(np.float32), mask[0].numpy()


def preprocess_structure(task: dict) -> Optional[dict]:
    """One complex ({"id", "pdb_path"}) as a preprocessed item, or None
    (logged) if it fails to parse."""
    try:
        pdb_path = task["pdb_path"]
        pep, _ = parse_pdb(os.path.join(pdb_path, "peptide.pdb"))
        if pep is None:
            raise ValueError("empty peptide")
        ca_mask = pep["mask_heavyatom"][:, C.BBHeavyAtom.CA]
        # float32 throughout: a Python-float epsilon would promote the
        # division, and every position after it, to float64.
        center = (pep["pos_heavyatom"][ca_mask, C.BBHeavyAtom.CA].sum(axis=0)
                  / np.float32(ca_mask.sum() + 1e-8)).astype(np.float32)
        pep["pos_heavyatom"] = pep["pos_heavyatom"] - center[None, None, :]
        pep["torsion_angle"], pep["torsion_angle_mask"] = _torsions(pep["pos_heavyatom"],
                                                                    pep["aa"])
        if len(pep["aa"]) < 3 or len(pep["aa"]) > 25:
            raise ValueError("peptide length not in [3,25]")

        rec, _ = parse_pdb(os.path.join(pdb_path, "pocket.pdb"))
        if rec is None:
            raise ValueError("empty pocket")
        rec["pos_heavyatom"] = rec["pos_heavyatom"] - center[None, None, :]
        rec["torsion_angle"], rec["torsion_angle_mask"] = _torsions(rec["pos_heavyatom"],
                                                                    rec["aa"])
        rec["chain_nb"] = rec["chain_nb"] + 1

        data = {"id": task["id"],
                "generate_mask": np.concatenate([np.zeros(len(rec["aa"]), dtype=bool),
                                                 np.ones(len(pep["aa"]), dtype=bool)])}
        for k in rec:
            if isinstance(rec[k], np.ndarray):
                data[k] = np.concatenate([rec[k], pep[k]], axis=0)
            elif isinstance(rec[k], list):
                data[k] = rec[k] + pep[k]
            else:
                raise ValueError(f"Unknown field type for {k}")
        return data
    except (KeyError, ValueError, TypeError, OSError) as e:
        logger.warning("[%s] %s: %s", task.get("id"), e.__class__.__name__, e)
        return None


class PepDataset:
    """Preprocess once into ``<dataset_dir>/<name>_structure_cache.rec``,
    then read items from it."""

    def __init__(self, structure_dir: str, dataset_dir: str, name: str = "pep",
                 n_jobs: Optional[int] = None):
        self.structure_dir = structure_dir
        self.dataset_dir = dataset_dir
        self.name = name
        self._store: Optional[recordstore.RecordStore] = None
        if not recordstore.exists(self._cache_path):
            self._preprocess(n_jobs)

    @property
    def _cache_path(self) -> str:
        return os.path.join(self.dataset_dir, f"{self.name}_structure_cache.rec")

    def _preprocess(self, n_jobs: Optional[int] = None) -> None:
        os.makedirs(self.dataset_dir, exist_ok=True)
        tasks = [{"id": name, "pdb_path": os.path.join(self.structure_dir, name)}
                 for name in sorted(os.listdir(self.structure_dir))
                 if os.path.isdir(os.path.join(self.structure_dir, name))]
        n_jobs = n_jobs or max((os.cpu_count() or 2) // 2, 1)
        if n_jobs == 1 or len(tasks) <= 1:
            results = [preprocess_structure(t) for t in tasks]
        else:
            with concurrent.futures.ProcessPoolExecutor(
                    max_workers=min(n_jobs, len(tasks)),
                    mp_context=multiprocessing.get_context("spawn")) as pool:
                results = list(pool.map(preprocess_structure, tasks))
        with recordstore.RecordStoreWriter(self._cache_path) as w:
            for data in results:
                if data is not None:
                    w.put(data["id"], data)

    def _connect(self) -> recordstore.RecordStore:
        if self._store is None:
            self._store = recordstore.RecordStore(self._cache_path)
        return self._store

    def __len__(self) -> int:
        return len(self._connect())

    def __getitem__(self, i: int) -> dict:
        return self._connect()[i]

    @property
    def ids(self) -> list:
        return self._connect().keys
