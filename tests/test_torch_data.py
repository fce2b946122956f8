"""The port's host data path against the JAX package's: the PDB parser and
its helpers, the record store's bytes, and the preprocessing of a
PepMerge-style directory into the cache.

Inputs: complexes written by ``pepflowww_torch.data.synthetic`` from a
numpy seed, and one pocket edited to hold what real files hold (a residue
without CA, side chains cut short, an UNK residue, a modified residue,
alternate conformers, water). Positions must match exactly. Torsions: the
port takes them with ``pepflowww_torch.ops.allatom.get_torsion_angles``,
JAX with its own op, both in float32; the measured gap is 1.1e-5 rad (over
these 3 complexes and 12 more). Near a dihedral of 0 or π the arccos turns
one float32 step of its argument into up to ~4e-5 rad (its slope at the
clamp 0.999999 is ~700), so the tolerance is 1e-4 rad, on the circle.
"""

import numpy as np
import pytest

from pepflowww_tpu.data import dataset as jax_dataset
from pepflowww_tpu.data import pdb as jax_pdb
from pepflowww_tpu.data import recordstore as jax_rs

from pepflowww_torch.data import dataset, pdb, recordstore
from pepflowww_torch.data.synthetic import write_structure_dir

TORSION_TOL = 1e-4


def _edit_pocket(text: str) -> str:
    """A pocket with the faults of real files: residue 2 loses its CA,
    residue 3's side chain is cut after CB, residue 4 becomes UNK, residue 5
    becomes MSE (a modified MET), every atom of residue 6 gets an alternate
    conformer B 1 Å away, and a water follows."""
    out = []
    for line in text.splitlines():
        if line.startswith("ATOM"):
            resseq, name = int(line[22:26]), line[12:16].strip()
            if resseq == 2 and name == "CA":
                continue
            if resseq == 3 and name not in ("N", "CA", "C", "O", "CB"):
                continue
            if resseq == 4:
                line = line[:17] + "UNK" + line[20:]
            if resseq == 5:
                line = "HETATM" + line[6:17] + "MSE" + line[20:]
            if resseq == 6:
                out.append(line[:16] + "A" + line[17:])
                x = float(line[30:38]) + 1.0
                line = line[:16] + "B" + line[17:30] + f"{x:8.3f}" + line[38:]
        if line.startswith("END"):
            out.append("HETATM 9999  O   HOH W 900       1.000   2.000   3.000  1.00  0.00"
                       "           O")
        out.append(line)
    return "\n".join(out) + "\n"


@pytest.fixture(scope="module")
def structs(tmp_path_factory):
    root = tmp_path_factory.mktemp("structs")
    ids = write_structure_dir(str(root / "dir"), sizes=[(5, 20), (12, 33), (3, 41)], seed=3)
    pocket = root / "dir" / ids[1] / "pocket.pdb"
    pocket.write_text(_edit_pocket(pocket.read_text()))
    return root, ids


def _assert_items_equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        if k in ("torsion_angle",):
            d = np.asarray(a[k]) - np.asarray(b[k])
            assert np.abs(np.arctan2(np.sin(d), np.cos(d))).max() <= TORSION_TOL, k
        elif isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


def test_parse_pdb_and_helpers_match_jax(structs):
    root, ids = structs
    for cid in ids:
        for part in ("peptide.pdb", "pocket.pdb"):
            path = str(root / "dir" / cid / part)
            got, got_map = pdb.parse_pdb(path)
            want, want_map = jax_pdb.parse_pdb(path)
            _assert_items_equal(got, want)
            assert got_map == want_map
            assert pdb.get_fasta_from_pdb(path) == jax_pdb.get_fasta_from_pdb(path)
            for a, b in ((pdb.renumber_pdb(got, start=7), jax_pdb.renumber_pdb(want, start=7)),
                         (pdb.strip_to_backbone(got), jax_pdb.strip_to_backbone(want))):
                _assert_items_equal(a, b)
            assert pdb.save_pdb(got) == jax_pdb.save_pdb(want)
    # The edited pocket: no CA -> skipped, UNK counted and skipped, MSE read
    # as MET, conformer A kept, water skipped; an UNK share of 1/33 passes a
    # threshold of 0.5 and fails one of 0.01.
    path = str(root / "dir" / ids[1] / "pocket.pdb")
    text = open(path).read()
    got, _ = pdb.parse_pdb(text)
    assert len(got["aa"]) == 33 - 2 and 2 not in got["resseq"] and 4 not in got["resseq"]
    assert got["aa"][list(got["resseq"]).index(5)] == 10
    assert got["mask_heavyatom"][list(got["resseq"]).index(3), 5:].sum() == 0
    assert pdb.parse_pdb(path, unknown_threshold=0.5)[0] is not None
    assert pdb.parse_pdb(path, unknown_threshold=0.01) == (None, None)
    assert jax_pdb.parse_pdb(path, unknown_threshold=0.01) == (None, None)


def test_recordstore_bytes_and_cross_reads(tmp_path, structs):
    root, ids = structs
    items = [pdb.parse_pdb(str(root / "dir" / cid / "pocket.pdb"))[0] for cid in ids]
    for w_mod, r_mod, tag in ((recordstore, jax_rs, "port"), (jax_rs, recordstore, "jax")):
        path = str(tmp_path / f"{tag}.rec")
        with w_mod.RecordStoreWriter(path) as w:
            for cid, item in zip(ids, items):
                w.put(cid, item)
        assert r_mod.exists(path)
        store = r_mod.RecordStore(path)
        assert store.keys == ids and len(store) == 3
        for i, (cid, item) in enumerate(zip(ids, items)):
            _assert_items_equal(store.get(cid), item)
            _assert_items_equal(store[i], item)
        store.close()
    for suffix in ("", ".idx"):
        assert open(tmp_path / f"port.rec{suffix}", "rb").read() == \
            open(tmp_path / f"jax.rec{suffix}", "rb").read()


def test_preprocess_and_dataset_match_jax(tmp_path, structs):
    root, ids = structs
    task = {"id": ids[1], "pdb_path": str(root / "dir" / ids[1])}
    _assert_items_equal(dataset.preprocess_structure(task),
                        jax_dataset.preprocess_structure(task))
    assert dataset.preprocess_structure({"id": "x", "pdb_path": str(tmp_path)}) is None

    ds = dataset.PepDataset(str(root / "dir"), str(tmp_path / "pt"), name="t", n_jobs=2)
    jds = jax_dataset.PepDataset(str(root / "dir"), str(tmp_path / "jx"), name="t", n_jobs=1)
    assert ds.ids == jds.ids == ids and len(ds) == 3
    for i in range(3):
        _assert_items_equal(ds[i], jds[i])
    assert [len(ds[i]["aa"]) for i in range(3)] == [25, 33 - 2 + 12, 44]
    # each package reads the other's cache
    cross = dataset.PepDataset(str(root / "dir"), str(tmp_path / "jx"), name="t")
    jcross = jax_dataset.PepDataset(str(root / "dir"), str(tmp_path / "pt"), name="t")
    for i in range(3):
        _assert_items_equal(cross[i], jds[i])
        _assert_items_equal(jcross[i], ds[i])


@pytest.mark.parametrize("case,sizes,kept", [
    ("peptide of 2", (2, 20), False), ("peptide of 3", (3, 20), True),
    ("peptide of 25", (25, 20), True), ("peptide of 26", (26, 20), False),
    ("empty pocket", (5, 20), False)])
def test_preprocess_length_filter_and_empty_pocket_match_jax(tmp_path, case, sizes, kept):
    ids = write_structure_dir(str(tmp_path), sizes=[sizes], seed=7)
    if case == "empty pocket":
        (tmp_path / ids[0] / "pocket.pdb").write_text("END\n")
    task = {"id": ids[0], "pdb_path": str(tmp_path / ids[0])}
    got, want = dataset.preprocess_structure(task), jax_dataset.preprocess_structure(task)
    assert (got is not None) == (want is not None) == kept
    if kept:
        _assert_items_equal(got, want)
        assert got["generate_mask"].sum() == sizes[0] and len(got["aa"]) == sum(sizes)
