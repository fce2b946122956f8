"""The port's metrics, Kabsch alignment and PDB export against the JAX
package's on the same inputs (made from a numpy seed).

Both sides run float32; the Kabsch alignments differ only by their SVD
libraries' rounding: the metrics agree to 1e-4 (measured ≤ 3.6e-7 on these
inputs), and the written PDB coordinates, printed to 1e-3 Å, to one printed
step.
"""

import csv
import json

import numpy as np
import torch

from pepflowww_tpu import inference as jax_inference
from pepflowww_tpu import metrics as jax_metrics
from pepflowww_tpu.ops import frames as jax_frames

from pepflowww_torch import inference, metrics
from pepflowww_torch.data.synthetic import make_batch
from pepflowww_torch.ops import frames

TOL = 1e-4


def _inputs(seed=0, B=3, L=12):
    rng = np.random.default_rng(seed)
    a = rng.normal(scale=4.0, size=(B, L, 3)).astype(np.float32)
    q = np.linalg.qr(rng.normal(size=(B, 3, 3)))[0].astype(np.float32)
    b = (a @ q.transpose(0, 2, 1) + rng.normal(size=(B, 1, 3)) * 3
         + rng.normal(scale=0.7, size=(B, L, 3))).astype(np.float32)
    mask = rng.random((B, L)) > 0.3
    mask[:, :3] = True
    return rng, a, b, mask


def test_kabsch_and_metrics_match_jax():
    rng, a, b, mask = _inputs()
    got = frames.kabsch_align(torch.from_numpy(a), torch.from_numpy(b),
                              torch.from_numpy(mask.astype(np.float32)))
    want = jax_frames.kabsch_align(a, b, mask.astype(np.float32))
    for x, y in zip(got, want):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=TOL)
    R = got[1].numpy()
    np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-5)
    # A mirror image: the best proper rotation still has det +1.
    mirrored = frames.kabsch_align(torch.from_numpy(a * np.array([1, 1, -1], np.float32)),
                                   torch.from_numpy(a), torch.ones(mask.shape))[1]
    np.testing.assert_allclose(np.linalg.det(mirrored.numpy()), 1.0, atol=1e-5)

    Ra = np.linalg.qr(rng.normal(size=(3, 12, 3, 3)))[0].astype(np.float32)
    Rb = np.linalg.qr(rng.normal(size=(3, 12, 3, 3)))[0].astype(np.float32)
    sa, sb = rng.integers(0, 20, size=(3, 12)), rng.integers(0, 20, size=(3, 12))
    sb[:, :4] = sa[:, :4]
    for name, args in (("ca_rmsd", (a, b, mask)), ("ca_rmsd_aligned", (a, b, mask)),
                       ("tm_score", (a, b, mask)), ("rotation_frobenius", (Ra, Rb, mask)),
                       ("amino_acid_recovery", (sa, sb, mask))):
        np.testing.assert_allclose(getattr(metrics, name)(*args),
                                   getattr(jax_metrics, name)(*args), atol=TOL, err_msg=name)
    # tm_score is 1 and the aligned RMSD 0 for a rigid motion of itself.
    moved = a @ R.transpose(0, 2, 1) + 2.0
    np.testing.assert_allclose(metrics.tm_score(moved, a, mask), 1.0, atol=1e-5)
    np.testing.assert_allclose(metrics.ca_rmsd_aligned(moved, a, mask), 0.0, atol=1e-3)


def _sample_out(seed=1, B=2):
    """A numpy batch of B synthetic complexes (L=32) and a perturbed
    "sampler output" for it (tensors)."""
    rng = np.random.default_rng(seed)
    batch = make_batch(rng, batch_size=B, pep_len=7, rec_len=21, pad_to=32)
    pos = batch["pos_heavyatom"]
    t1 = torch.from_numpy(pos[:, :, 1])
    R1 = frames.construct_3d_basis(t1, torch.from_numpy(pos[:, :, 2]),
                                   torch.from_numpy(pos[:, :, 0]))
    noise = lambda *s, sc: torch.from_numpy((rng.normal(size=s) * sc).astype(np.float32))
    R = torch.linalg.qr(torch.eye(3) + noise(B, 32, 3, 3, sc=0.2))[0]
    R = R * torch.sign(torch.linalg.det(R))[..., None, None]
    seqs_1 = torch.from_numpy(batch["aa"])
    out = {"rotmats": R1 @ R, "trans": t1 + noise(B, 32, 3, sc=1.5),
           "angles": torch.from_numpy(rng.uniform(0, 2 * np.pi, (B, 32, 5)).astype(np.float32)),
           "seqs": torch.where(torch.from_numpy(rng.random((B, 32)) > 0.5),
                               seqs_1.clamp(max=19), torch.zeros_like(seqs_1)),
           "rotmats_1": R1, "trans_1": t1, "seqs_1": seqs_1}
    return batch, out


def test_evaluate_sample_matches_jax():
    batch, out = _sample_out()
    got = metrics.evaluate_sample(out, batch)
    want = jax_metrics.evaluate_sample({k: v.numpy() for k, v in out.items()}, batch)
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].shape == (2,)
        np.testing.assert_allclose(got[k], want[k], atol=TOL, err_msg=k)


def test_summarize_outputs_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    rows = [{"id": f"c{i % 3}", "sample": i, "ca_rmsd": float(rng.uniform(0.5, 9)),
             "ca_rmsd_aligned": float(rng.uniform(0.5, 9)), "aar": float(rng.random()),
             "tm_score": float(rng.random())} for i in range(12)]
    rows.append({"id": "c3", "sample": 0, "ca_rmsd_aligned": 1.2, "aar": 0.4})  # no tm_score
    got, want = metrics.summarize_outputs(rows), jax_metrics.summarize_outputs(rows)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert got["overall"]["num_complexes"] == 4
    assert metrics.summarize_outputs([]) == jax_metrics.summarize_outputs([])
    path = tmp_path / "outputs.csv"
    path.write_text("id,sample,ca_rmsd,ca_rmsd_aligned,aar,tm_score\n"
                    + "".join(f"{r['id']},{r['sample']},{r['ca_rmsd']},{r['ca_rmsd_aligned']},"
                              f"{r['aar']},{r['tm_score']}\n" for r in rows[:12]))
    with open(path, newline="") as f:   # the CSV's rows, as strings
        got = metrics.summarize_outputs(list(csv.DictReader(f)))
    assert got == jax_metrics.summarize_outputs_csv(str(path))


def _atoms(path):
    lines = [ln for ln in open(path).read().splitlines() if ln.startswith("ATOM")]
    return ([ln[:30] + ln[54:] for ln in lines],
            np.array([[float(ln[30:38]), float(ln[38:46]), float(ln[46:54])] for ln in lines]))


def test_write_sample_pdbs_matches_jax(tmp_path):
    batch, out = _sample_out(seed=4)
    out_np = {k: v.numpy() for k, v in out.items()}
    got = inference.write_sample_pdbs(out, batch, str(tmp_path / "pt"))
    want = jax_inference.write_sample_pdbs(out_np, batch, str(tmp_path / "jx"))
    assert [p.split("/")[-1] for p in got] == [p.split("/")[-1] for p in want] == \
        ["sample_0.pdb", "sample_1.pdb"]
    for a, b in zip(got, want):
        (ta, xa), (tb, xb) = _atoms(a), _atoms(b)
        assert ta == tb
        np.testing.assert_allclose(xa, xb, atol=1.01e-3)
