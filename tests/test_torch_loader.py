"""The port's length-bucketed loader and dataset cache against the JAX
package's: the batch plan index for index, batches read from one cache
array for array, the bucketing-waste and shard properties of
tests/test_data.py, the prefetch thread, the ``.lens.json`` sidecar read
across packages, ``reset`` and the exclusion file (where a cache built
without the exclusions is opened with them, the port's raises and JAX's
keeps the held-out ids), and the empty epoch (where the JAX loader's
``infinite()`` spins, the port's raises).

Inputs: seeded lengths in fake datasets, and a PepMerge-style directory
written by ``pepflowww_torch.data.synthetic`` from a numpy seed.
"""

import threading
import time

import numpy as np
import pytest

from pepflowww_tpu.data import dataset as jax_dataset

from pepflowww_torch.data import dataset
from pepflowww_torch.data.collate import DEFAULT_BUCKETS, bucket_length
from pepflowww_torch.data.synthetic import write_structure_dir


class FakeDS:
    """Items of seeded lengths: only ``aa`` (and an id)."""

    def __init__(self, lens):
        self.lens = lens

    def __len__(self):
        return len(self.lens)

    def __getitem__(self, i):
        return {"aa": np.full(int(self.lens[i]), 7, dtype=np.int64), "id": str(i)}


PLAN_CASES = [dict(batch_size=8, shuffle=True, seed=0),
              dict(batch_size=8, shuffle=False, seed=0),
              dict(batch_size=5, shuffle=True, seed=3, drop_last=False),
              dict(batch_size=5, shuffle=False, seed=3, drop_last=False),
              dict(batch_size=4, shuffle=True, seed=1, num_shards=2, shard_index=1),
              dict(batch_size=4, shuffle=True, seed=2, buckets=()),
              dict(batch_size=6, shuffle=True, seed=4, bucket_by_length=False),
              dict(batch_size=6, shuffle=True, seed=5, pad_to=160, drop_last=False)]


def test_batch_plan_matches_jax():
    """Three epochs of plans, pad_to for pad_to and index for index, in
    every case of PLAN_CASES; and the batches each shard yields."""
    lens = np.random.default_rng(0).integers(20, 150, size=200)
    for case in PLAN_CASES:
        ours = dataset.DataLoader(FakeDS(lens), **case)
        theirs = jax_dataset.DataLoader(FakeDS(lens), **case)
        for _ in range(3):
            assert ours._batch_plan() == theirs._batch_plan(), case
        for a, b in zip(ours, theirs):
            assert a["aa"].shape == b["aa"].shape, case
            np.testing.assert_array_equal(a["res_mask"], b["res_mask"])


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """Ten complexes of seeded lengths (buckets 32 to 96), preprocessed by
    the port into one cache."""
    root = tmp_path_factory.mktemp("loader")
    rng = np.random.default_rng(7)
    sizes = [(int(rng.integers(3, 26)), int(rng.integers(10, 70))) for _ in range(10)]
    ids = write_structure_dir(str(root / "structs"), sizes=sizes, seed=3)
    ds = dataset.PepDataset(str(root / "structs"), str(root / "cache"), name="t", n_jobs=1)
    return root, ids, ds


def test_batches_from_one_cache_equal_jax(written):
    """The port's batches and JAX's, from one cache, array-equal over two
    epochs (JAX casts index fields to int32; the values are the same)."""
    root, ids, ds = written
    jds = jax_dataset.PepDataset(str(root / "structs"), str(root / "cache"), name="t")
    assert jds.ids == ds.ids == ids
    ours = dataset.DataLoader(ds, batch_size=2, shuffle=True, seed=4, drop_last=False)
    theirs = jax_dataset.DataLoader(jds, batch_size=2, shuffle=True, seed=4, drop_last=False)
    n = 0
    for _ in range(2):
        for a, b in zip(ours, theirs):
            assert set(b) <= set(a)
            for k in b:
                assert a[k].shape == b[k].shape, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            n += 1
    assert n >= 10


def _counting(ds):
    """Count the store's record reads of `ds`."""
    store = ds._connect()
    calls = []
    get = store.get
    store.get = lambda k: calls.append(k) or get(k)
    return calls


def test_lengths_sidecar_is_jax_bytes_and_read_across(written):
    root, ids, ds = written
    sidecar = root / "cache" / "t_structure_cache.rec.lens.json"
    new = lambda pkg: pkg.PepDataset(str(root / "structs"), str(root / "cache"), name="t")

    sidecar.unlink(missing_ok=True)
    jds = new(jax_dataset)
    jlens = jds.lengths
    jax_bytes = sidecar.read_bytes()
    ours = new(dataset)
    calls = _counting(ours)
    np.testing.assert_array_equal(ours.lengths, jlens)
    assert calls == []                      # read JAX's sidecar, no record decompressed

    sidecar.unlink()
    ours = new(dataset)
    calls = _counting(ours)
    lens = ours.lengths
    assert len(calls) == len(ids)           # computed once ...
    assert sidecar.read_bytes() == jax_bytes
    jds = new(jax_dataset)
    calls = _counting(jds)
    np.testing.assert_array_equal(jds.lengths, lens)
    assert calls == []                      # ... and JAX reads the port's
    assert lens.tolist() == [len(ds[i]["aa"]) for i in range(len(ds))]


def test_reset_and_exclusion_match_jax(tmp_path):
    ids = write_structure_dir(str(tmp_path / "structs"), sizes=[(4, 12), (6, 20), (5, 9)],
                              seed=2)
    names = tmp_path / "names.txt"
    names.write_text(f"{ids[1]}\n\n")
    got = {}
    for tag, pkg in (("torch", dataset), ("jax", jax_dataset)):
        kw = dict(name=f"x_{tag}", exclude_names_file=str(names), n_jobs=1)
        ds = pkg.PepDataset(str(tmp_path / "structs"), str(tmp_path / "cache"), **kw)
        got[tag] = [ds.ids, ds.lengths.tolist()]
        names_no = tmp_path / "none.txt"    # reset: rebuilt without the exclusions
        ds = pkg.PepDataset(str(tmp_path / "structs"), str(tmp_path / "cache"), reset=True,
                            **{**kw, "exclude_names_file": str(names_no)})
        got[tag] += [ds.ids, ds.lengths.tolist()]
    assert got["torch"][0] == [ids[0], ids[2]] and got["torch"][2] == ids
    assert got["torch"] == got["jax"]
    # The exclusions against a cache built without them: JAX's keeps the
    # held-out id, the port's raises and names it.
    again = dict(exclude_names_file=str(names), n_jobs=1)
    assert jax_dataset.PepDataset(str(tmp_path / "structs"), str(tmp_path / "cache"),
                                  name="x_jax", **again).ids == ids
    with pytest.raises(ValueError, match=f"{ids[1]}.*reset=True"):
        dataset.PepDataset(str(tmp_path / "structs"), str(tmp_path / "cache"), name="x_torch",
                           **again)


def test_bucketing_waste_and_shards():
    """tests/test_data.py's properties, on the port's loader: bucketed
    batches waste under a quarter and under half of mixed batches' padding,
    use no more shapes than buckets, pad each batch to the smallest bucket
    that fits; the shards of a plan share each step's shape and split each
    global batch without overlap."""
    lens = np.random.default_rng(0).integers(20, 150, size=256)

    def measure(loader):
        padded = real = 0
        shapes = set()
        for b in loader:
            padded += b["aa"].size
            real += int(b["res_mask"].sum())
            shapes.add(b["aa"].shape)
        return padded / real - 1.0, shapes

    w_mixed, _ = measure(dataset.DataLoader(FakeDS(lens), batch_size=8, shuffle=True, seed=0,
                                            bucket_by_length=False))
    w_bucket, s_bucket = measure(dataset.DataLoader(FakeDS(lens), batch_size=8, shuffle=True,
                                                    seed=0))
    assert w_bucket < w_mixed / 2 and w_bucket < 0.25, (w_bucket, w_mixed)
    assert len(s_bucket) <= len(DEFAULT_BUCKETS)
    for pad_to, idxs in dataset.DataLoader(FakeDS(lens), batch_size=8, seed=1)._batch_plan():
        assert bucket_length(max(int(lens[i]) for i in idxs)) == pad_to

    lens = np.random.default_rng(3).integers(20, 120, size=64)
    shards = [dataset.DataLoader(FakeDS(lens), batch_size=2, shuffle=True, seed=5, num_shards=2,
                                 shard_index=s) for s in range(2)]
    b0, b1 = list(shards[0]), list(shards[1])
    assert len(b0) == len(b1) > 0
    for x, y in zip(b0, b1):
        assert x["aa"].shape == y["aa"].shape and x["aa"].shape[0] == 2
        assert not set(x["id"]) & set(y["id"])


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "DataLoader.prefetch" and t.is_alive()]


def test_prefetch_crosses_epochs_and_stops_on_close():
    """Seven batches of a three-batch epoch, in the order of infinite(),
    also when the consumer pauses with the queue full (JAX's producer drops
    the batch it holds then); close() stops the thread."""
    lens = np.random.default_rng(1).integers(10, 30, size=6)
    it = dataset.DataLoader(FakeDS(lens), batch_size=2, shuffle=True, seed=0).prefetch(depth=2)
    got = [next(it) for _ in range(2)]
    time.sleep(0.6)
    got += [next(it) for _ in range(5)]
    want = dataset.DataLoader(FakeDS(lens), batch_size=2, shuffle=True, seed=0).infinite()
    for a in got:
        assert a["id"] == next(want)["id"]
    assert _prefetch_threads()
    it.close()
    assert not _prefetch_threads()


def test_empty_epoch_raises():
    """Every bucket smaller than one global batch with drop_last: the
    port's plan raises a ValueError naming the bucket counts, also through
    prefetch() (JAX's gives an empty plan, and its infinite() spins)."""
    lens = np.array([30, 31, 40, 60, 61])          # buckets 32: 2, 48: 1, 64: 2
    theirs = jax_dataset.DataLoader(FakeDS(lens), batch_size=3, seed=0)
    assert theirs._batch_plan() == []
    loader = dataset.DataLoader(FakeDS(lens), batch_size=3, seed=0)
    with pytest.raises(ValueError, match=r"\{32: 2, 48: 1, 64: 2\}"):
        loader._batch_plan()
    with pytest.raises(ValueError, match="no length bucket"):
        next(loader.prefetch())
    assert not _prefetch_threads()
    with pytest.raises(ValueError, match="no batch"):
        next(iter(dataset.DataLoader(FakeDS(lens), batch_size=8, bucket_by_length=False)))
    plan = dataset.DataLoader(FakeDS(lens), batch_size=3, seed=0, drop_last=False)._batch_plan()
    assert sorted(len(i) for _, i in plan) == [1, 2, 2]
