"""The port's server (``pepflowww_torch/serve.py``) against the JAX package's
(the root ``serve.py``, imported as ``tests/test_serve.py`` imports it and
left as it is): the item a request builds, the pad rule and the warm
ladder, and a group's PDBs and metrics for the same sampler output.

Inputs: complexes from ``pepflowww_torch.data.synthetic.make_complex`` with
a numpy seed. Positions read from PDB text must match exactly; torsions are
taken in float32 by each package's own op, within 1e-4 rad on the circle
(``tests/test_torch_data.py``). The placeholder peptide of a request
without one is each package's ``make_complex`` from the request's seed:
positions within 1e-4 Å and torsions within 1e-3 rad, as
``tests/test_torch_sampler.py::test_synthetic_batch_matches_jax`` holds
them.
"""

import numpy as np
import pytest
import torch

import serve as jax_serve

from pepflowww_torch import serve
from pepflowww_torch.data.collate import mask_select_data, replicate_item
from pepflowww_torch.data.pdb import save_pdb
from pepflowww_torch.data.synthetic import _random_rotmats, make_complex
from pepflowww_torch.ops import allatom

torch.set_num_threads(1)


def _complex_pdbs(seed: int, pep_len: int = 5, rec_len: int = 12):
    item = make_complex(np.random.default_rng(seed), pep_len=pep_len, rec_len=rec_len)
    return (save_pdb(mask_select_data(item, item["generate_mask"])),
            save_pdb(mask_select_data(item, ~item["generate_mask"])))


def _assert_items_close(got: dict, want: dict, pos_atol: float, tor_atol: float):
    assert sorted(got) == sorted(want)
    for k in got:
        if k == "torsion_angle":
            d = np.asarray(got[k]) - np.asarray(want[k])
            assert np.abs(np.arctan2(np.sin(d), np.cos(d))).max() <= tor_atol, k
        elif k == "pos_heavyatom":
            assert got[k].dtype == want[k].dtype
            np.testing.assert_allclose(got[k], want[k], atol=pos_atol, rtol=0, err_msg=k)
        elif isinstance(got[k], np.ndarray):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize("shape", ["native peptide", "peptide_len placeholder"])
def test_build_item_matches_jax(shape):
    pep_pdb, pocket_pdb = _complex_pdbs(seed=11)
    if shape == "native peptide":
        req = {"pocket_pdb": pocket_pdb, "peptide_pdb": pep_pdb}
        tol = (0.0, 1e-4)
    else:
        req = {"pocket_pdb": pocket_pdb, "peptide_len": 7, "seed": 3}
        tol = (1e-4, 1e-3)
    got, want = serve._build_item(req), jax_serve._build_item(req)
    _assert_items_close(got, want, *tol)
    assert int(got["generate_mask"].sum()) == (5 if shape == "native peptide" else 7)
    with pytest.raises(ValueError):
        serve._build_item({"pocket_pdb": "garbage", **({"peptide_pdb": pep_pdb}
                                                       if shape == "native peptide" else {})})


def test_pad_rule_and_warm_ladder():
    for n in range(1, 257):
        assert serve._pad_rule(n, 1) == jax_serve._pad_rule(n, 1) == serve._group_pad_size(n), n
    ladder = serve.warmup_sizes()
    assert ladder == [1, 2, 4, 8, 16, 32, 64]
    assert all(serve._group_pad_size(n) in ladder for n in range(1, 65))
    assert all(serve._pad_rule(n, 1) == n for n in ladder)
    # The JAX ladder starts at 8: the sizes below it are the port's on purpose.
    assert sorted(set(ladder) - set(jax_serve.warmup_sizes(1))) == [1, 2, 4]


def _fixed_output(rng, batch_np):
    """A sampler output for `batch_np` (numpy): generated rows drawn from
    `rng`, the data fields the batch's own."""
    B, L = batch_np["aa"].shape
    gen = batch_np["generate_mask"].astype(bool)
    with torch.no_grad():
        tor, _ = allatom.get_torsion_angles(torch.from_numpy(batch_np["pos_heavyatom"]),
                                            torch.from_numpy(batch_np["aa"]))
    rot_1 = _random_rotmats(rng, (B, L))
    trans_1 = batch_np["pos_heavyatom"][:, :, 1].astype(np.float32)
    seqs_1 = batch_np["aa"].astype(np.int64)
    seqs = np.where(gen, rng.integers(0, 20, size=(B, L)), seqs_1)
    return {
        "rotmats": np.where(gen[..., None, None], _random_rotmats(rng, (B, L)), rot_1),
        "trans": np.where(gen[..., None], trans_1 + rng.normal(size=(B, L, 3)).astype(np.float32),
                          trans_1).astype(np.float32),
        "angles": rng.uniform(-np.pi, np.pi, size=(B, L, 5)).astype(np.float32),
        "seqs": seqs.astype(np.int64),
        "rotmats_1": rot_1, "trans_1": trans_1, "angles_1": tor.numpy().astype(np.float32),
        "seqs_1": seqs_1,
    }


def _split_pdb(text: str):
    """(each line with its coordinates blanked, the (N, 3) coordinates)."""
    lines = text.splitlines()
    xyz = np.array([[float(ln[30:38]), float(ln[38:46]), float(ln[46:54])] for ln in lines
                    if ln.startswith("ATOM")])
    return [ln[:30] + ln[54:] if ln.startswith("ATOM") else ln for ln in lines], xyz


def test_run_group_matches_jax_for_the_same_sampler_output(monkeypatch, capsys):
    """Both `_run_group`s with their sampler swapped for one that returns
    the same output: the same PDB records, byte for byte on this seed's
    data (and in general the pocket's byte for byte and the generated
    atoms' coordinates within one unit of the last printed digit), metrics
    within 1e-5, and the padded row (3 real rows run as 4) dropped."""
    from pepflowww_torch.data.collate import pad_and_collate

    pep_pdb, pocket_pdb = _complex_pdbs(seed=5)
    item = serve._build_item({"pocket_pdb": pocket_pdb, "peptide_pdb": pep_pdb})
    rows = replicate_item(item, 3)
    bucket = 32
    fixed = _fixed_output(np.random.default_rng(9),
                          pad_and_collate(rows + [rows[-1]], pad_to=bucket))
    shapes = []

    def port_sampler(steps):
        def run(model, batch, generator):
            shapes.append(tuple(batch["aa"].shape))
            return {k: torch.from_numpy(v) for k, v in fixed.items()}
        return run

    def jax_sampler(steps):
        def run(params, batch, key):
            shapes.append(tuple(batch["aa"].shape))
            return dict(fixed)
        return run

    monkeypatch.setattr(serve, "_make_group_sampler", port_sampler)
    monkeypatch.setattr(jax_serve, "_make_group_sampler", jax_sampler)
    monkeypatch.setattr(jax_serve.S, "samplers", {})
    monkeypatch.setattr(jax_serve.S, "mesh", None)
    state = serve.ServeState(None, torch.device("cpu"), "test")
    got = serve._run_group(state, (bucket, 2), rows, [None])
    want = jax_serve._run_group((bucket, 2), rows, [None])

    assert shapes == [(4, bucket), (4, bucket)]
    assert len(got) == len(want) == 3 and state.key_counter == 1
    for g, w in zip(got, want):
        (gtext, gxyz), (wtext, wxyz) = _split_pdb(g["pdb"]), _split_pdb(w["pdb"])
        assert gtext == wtext and g["pdb"].count(" CA ") == len(item["aa"])
        # The pocket's lines are the batch's, byte for byte; the generated
        # atoms come from two float32 rebuilds that differ by up to ~2e-6 Å,
        # which can move the last printed digit.
        pocket = [ln[21] == "B" for ln in gtext if ln.startswith("ATOM")]
        np.testing.assert_array_equal(gxyz[pocket], wxyz[pocket])
        np.testing.assert_allclose(gxyz, wxyz, atol=1.01e-3, rtol=0)
        assert g["pdb"] == w["pdb"]  # on this seed's data, no digit moves
        for k in ("ca_rmsd", "aar", "tm_score"):
            assert abs(g[k] - w[k]) <= 1e-5, k
    assert "[serve] group bucket=32 n=3/4 steps=2 " in capsys.readouterr().out
