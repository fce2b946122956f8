"""PepMerge-style peptide–pocket dataset: preprocessing, the cache and the
length-bucketed loader (counterpart of the JAX package's
``data/dataset.py``).

* each complex lives in ``<structure_dir>/<id>/{peptide.pdb,pocket.pdb}``;
* both structures are centered on the peptide's CA centroid, and the
  torsions are taken after centering;
* the peptide's length must lie in [3, 25]; the receptor's chain_nb is
  shifted by one;
* an item is receptor ‖ peptide, with ``generate_mask`` marking the
  peptide;
* ids listed in an exclusion file (a test split's names) are left out of
  the cache.

The cache is a :class:`~pepflowww_torch.data.recordstore.RecordStore`,
byte-compatible with the JAX package's. Preprocessing is host work: the
torsions come from :func:`pepflowww_torch.ops.allatom.get_torsion_angles`
on the CPU, and the complexes fan out over a process pool started with
``spawn`` (a caller may hold a CUDA context, which a forked child must not
inherit). The per-item lengths persist in a ``.lens.json`` sidecar that
both packages read and write.

:class:`DataLoader` groups shuffled items by length bucket and yields numpy
batches; :func:`pepflowww_torch.data.collate.device_batch` moves one to a
device in the caller.
"""

from __future__ import annotations

import concurrent.futures
import functools
import json
import logging
import multiprocessing
import os
import queue
import threading
from typing import Iterator, Optional, Sequence

import numpy as np

from pepflowww_torch import constants as C
from pepflowww_torch.data import recordstore
from pepflowww_torch.data.collate import DEFAULT_BUCKETS, bucket_length, pad_and_collate
from pepflowww_torch.data.pdb import parse_pdb

logger = logging.getLogger(__name__)


def _torsions(pos15: np.ndarray, aa: np.ndarray):
    import torch

    from pepflowww_torch.ops import allatom

    with torch.no_grad():
        tor, mask = allatom.get_torsion_angles(torch.from_numpy(pos15)[None],
                                               torch.from_numpy(aa)[None])
    return tor[0].numpy().astype(np.float32), mask[0].numpy()


def preprocess_structure(task: dict, exclude: Sequence[str] = ()) -> Optional[dict]:
    """One complex ({"id", "pdb_path"}) as a preprocessed item, or None
    (logged) if its id is in `exclude` or it fails to parse."""
    try:
        if task["id"] in exclude:
            raise ValueError(f'{task["id"]} in exclusion list')
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
    then read items from it. ``reset`` rebuilds the cache;
    ``exclude_names_file`` lists ids (one a line) kept out of it, and an
    existing cache that holds one of them raises a ValueError."""

    def __init__(self, structure_dir: str, dataset_dir: str, name: str = "pep",
                 reset: bool = False, exclude_names_file: Optional[str] = None,
                 n_jobs: Optional[int] = None):
        self.structure_dir = structure_dir
        self.dataset_dir = dataset_dir
        self.name = name
        self._store: Optional[recordstore.RecordStore] = None
        self._lengths: Optional[np.ndarray] = None
        self.exclude = []
        if exclude_names_file and os.path.exists(exclude_names_file):
            with open(exclude_names_file) as f:
                self.exclude = [line.strip() for line in f if line.strip()]
        cache = self._cache_path
        if reset and recordstore.exists(cache):
            for path in (cache, cache + ".idx", cache + ".lens.json"):
                if os.path.exists(path):
                    os.remove(path)
        if not recordstore.exists(cache):
            self._preprocess(n_jobs)
        held_out = sorted(set(self.exclude) & set(self.ids)) if self.exclude else []
        if held_out:
            raise ValueError(
                f"{cache} holds {len(held_out)} ids that {exclude_names_file} excludes "
                f"({', '.join(held_out[:3])}{', ...' if len(held_out) > 3 else ''}): it was "
                f"built without that exclusion; pass reset=True or remove it to rebuild it")

    @property
    def _cache_path(self) -> str:
        return os.path.join(self.dataset_dir, f"{self.name}_structure_cache.rec")

    def _preprocess(self, n_jobs: Optional[int] = None) -> None:
        os.makedirs(self.dataset_dir, exist_ok=True)
        tasks = [{"id": name, "pdb_path": os.path.join(self.structure_dir, name)}
                 for name in sorted(os.listdir(self.structure_dir))
                 if os.path.isdir(os.path.join(self.structure_dir, name))]
        one = functools.partial(preprocess_structure, exclude=tuple(self.exclude))
        n_jobs = n_jobs or max((os.cpu_count() or 2) // 2, 1)
        if n_jobs == 1 or len(tasks) <= 1:
            results = [one(t) for t in tasks]
        else:
            with concurrent.futures.ProcessPoolExecutor(
                    max_workers=min(n_jobs, len(tasks)),
                    mp_context=multiprocessing.get_context("spawn")) as pool:
                results = list(pool.map(one, tasks))
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

    @property
    def lengths(self) -> np.ndarray:
        """Residues (pocket + peptide) of each item, for length bucketing.

        Read from the ``.lens.json`` sidecar when it matches the store (its
        size and mtime, and its ids), else computed by decompressing every
        record and written there (a temporary file, then a rename, so a
        concurrent reader never sees half a file). The sidecar's bytes are
        those the JAX package writes."""
        if self._lengths is not None:
            return self._lengths
        store = self._connect()
        sidecar = self._cache_path + ".lens.json"
        st = os.stat(self._cache_path)
        stamp = [int(st.st_size), int(st.st_mtime_ns)]
        try:
            with open(sidecar) as f:
                d = json.load(f)
            if (isinstance(d, dict) and d.get("__store__") == stamp
                    and set(d.get("lens", {}).keys()) == set(store.keys)):
                self._lengths = np.array([d["lens"][k] for k in store.keys], dtype=np.int64)
                return self._lengths
        except (OSError, json.JSONDecodeError):
            pass   # absent, unreadable, or being written by another process
        self._lengths = np.array([len(store.get(k)["aa"]) for k in store.keys], dtype=np.int64)
        tmp = sidecar + f".tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump({"__store__": stamp,
                           "lens": {k: int(n) for k, n in zip(store.keys, self._lengths)}}, f)
            os.replace(tmp, sidecar)
        except OSError:
            try:
                os.remove(tmp)
            except OSError:
                pass
        return self._lengths


class DataLoader:
    """Length-bucketed, shuffled batches of a dataset, as numpy dicts
    (:func:`~pepflowww_torch.data.collate.pad_and_collate`'s).

    Each epoch draws one plan from ``default_rng(seed + epoch)``: the items
    in shuffled order, grouped by length bucket, each bucket cut into global
    batches of ``batch_size * num_shards`` (a ragged tail dropped with
    ``drop_last``, and always with more than one shard), and the batches
    shuffled. Every shard derives the same plan and takes its contiguous
    block of each global batch, so all shards see the same padded length at
    the same step. ``pad_to`` fixes the padded length and turns bucketing
    off; ``bucket_by_length=False`` batches in shuffled order and pads each
    batch to the default bucket above its longest item. The plan is the JAX
    package's, index for index.

    Unlike the JAX loader, a plan with no batch raises ``ValueError`` (the
    items per bucket in its message) instead of letting :meth:`infinite`
    spin for ever.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 0,
                 num_shards: int = 1, shard_index: int = 0, drop_last: bool = True,
                 pad_to: Optional[int] = None, buckets: Sequence[int] = DEFAULT_BUCKETS,
                 bucket_by_length: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.drop_last = drop_last
        self.pad_to = pad_to
        self.buckets = buckets
        self.bucket_by_length = bucket_by_length and pad_to is None
        self._epoch = 0
        self._lens: Optional[np.ndarray] = None

    def _lengths(self) -> np.ndarray:
        if self._lens is None:
            lens = getattr(self.dataset, "lengths", None)
            if lens is None:
                lens = [len(self.dataset[i]["aa"]) for i in range(len(self.dataset))]
            self._lens = np.asarray(lens, dtype=np.int64)
        return self._lens

    def _batch_plan(self) -> list:
        """[(pad_to, global index list)] for the next epoch, the same on
        every shard."""
        n = len(self.dataset)
        order = np.arange(n)
        rng = np.random.default_rng(self.seed + self._epoch)
        if self.shuffle:
            rng.shuffle(order)
        self._epoch += 1
        gbs = self.batch_size * self.num_shards
        drop_last = self.drop_last or self.num_shards > 1

        if not self.bucket_by_length:
            end = len(order) - (len(order) % gbs) if drop_last else len(order)
            plan = [(self.pad_to, order[i:i + gbs].tolist()) for i in range(0, end, gbs)]
            if not plan:
                raise ValueError(f"DataLoader: {n} items make no batch of {gbs} "
                                 f"(drop_last={drop_last})")
            return plan

        lengths = self._lengths()
        groups: dict = {}
        for idx in order.tolist():
            groups.setdefault(bucket_length(int(lengths[idx]), self.buckets), []).append(idx)
        plan = []
        for b in sorted(groups):
            g = groups[b]
            end = len(g) - (len(g) % gbs) if drop_last else len(g)
            for i in range(0, end, gbs):
                plan.append((b, g[i:i + gbs]))
        if not plan:
            counts = {b: len(g) for b, g in sorted(groups.items())}
            raise ValueError(f"DataLoader: no length bucket holds a batch of {gbs} "
                             f"(batch_size {self.batch_size} x {self.num_shards} shards, "
                             f"drop_last={drop_last}); items per bucket: {counts}")
        if self.shuffle:
            rng.shuffle(plan)
        return plan

    def __iter__(self) -> Iterator[dict]:
        for pad_to, idxs in self._batch_plan():
            lo = self.shard_index * self.batch_size
            mine = idxs[lo:lo + self.batch_size]
            if len(mine) == 0:
                continue
            yield pad_and_collate([self.dataset[int(j)] for j in mine], pad_to=pad_to)

    def infinite(self) -> Iterator[dict]:
        while True:
            yield from iter(self)

    def prefetch(self, depth: int = 2) -> Iterator[dict]:
        """:meth:`infinite` with the reads and the padding on a background
        thread, at most `depth` batches ahead. The thread stops when the
        generator is closed (``close()``, or garbage collection)."""
        q: "queue.Queue" = queue.Queue(maxsize=depth)
        stop = threading.Event()
        failure = []

        def producer():
            it = self.infinite()
            try:
                while not stop.is_set():
                    batch = next(it)
                    while not stop.is_set():
                        try:
                            q.put(batch, timeout=0.1)
                            break
                        except queue.Full:
                            continue
            except BaseException as e:   # handed to the consumer below
                failure.append(e)
                stop.set()

        thread = threading.Thread(target=producer, daemon=True, name="DataLoader.prefetch")
        thread.start()
        try:
            while True:
                try:
                    yield q.get(timeout=0.1)
                except queue.Empty:
                    if failure:
                        raise failure[0]
                    if not thread.is_alive():
                        raise RuntimeError("DataLoader.prefetch: the producer thread stopped")
        finally:
            stop.set()
            thread.join()
