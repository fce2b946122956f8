"""The port's train CLI over a PepMerge-style directory on the CPU (a small
model: 2 blocks, narrow widths), and its loss on the loader's first real
batch against the JAX package's.

The CLI runs with a validation split and an exclusion file, then resumes
from its checkpoint; without a validation split the plateau scheduler
steps on the training loss at every log line, as the JAX train CLI's
does. The loss check takes the first batch of each package's loader from
one cache, golden weights carried across by ``convert.py``, and the JAX
loss's own corruption draws injected into the port, with the tolerances
of tests/test_torch_train.py::test_one_step_matches_jax (rtol 1e-4).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from pepflowww_tpu.convert import convert_state_dict
from pepflowww_tpu.data import dataset as jax_dataset
from pepflowww_tpu.models.flow import FlowModel as JaxFlowModel
from pepflowww_tpu.models.flow import FlowModelConfig as JaxFlowModelConfig
from pepflowww_tpu.models.trunk import IPAConfig as JaxIPAConfig
from pepflowww_tpu.ops import so3 as jso3
from pepflowww_tpu.ops import torus as jtorus
from pepflowww_tpu.training.optim import PlateauScheduler as JaxPlateau
from pepflowww_tpu.training.train_step import make_loss_fn

from pepflowww_torch import train
from pepflowww_torch.data import dataset
from pepflowww_torch.data.collate import device_batch
from pepflowww_torch.data.synthetic import write_structure_dir
from pepflowww_torch.models.flow import FlowModelConfig, build_model
from pepflowww_torch.models.trunk import IPAConfig
from pepflowww_torch.training.train_step import loss_and_total

torch.set_num_threads(2)
WEIGHTS = {"trans_loss": 0.5, "rot_loss": 0.5, "bb_atom_loss": 0.25,
           "seqs_loss": 1.0, "angle_loss": 1.0, "torsion_loss": 0.5}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """Six training complexes (all in the 32 bucket), three validation
    complexes (a ragged last batch at B=2), an exclusion file naming one
    training id, and a small config."""
    root = tmp_path_factory.mktemp("train_data")
    ids = write_structure_dir(str(root / "structs"), seed=5, sizes=[
        (4, 14), (5, 20), (3, 12), (6, 22), (7, 18), (4, 25)])
    write_structure_dir(str(root / "val"), sizes=[(5, 15), (3, 20), (8, 16)], seed=6)
    (root / "names.txt").write_text(f"{ids[2]}\n")
    raw = yaml.safe_load(open(os.path.join(ROOT, "configs", "learn_angle_tpu.yaml")))
    raw["model"]["encoder"].update(node_embed_size=32, edge_embed_size=16)
    raw["model"]["encoder"]["ipa"].update(c_s=32, c_z=16, c_hidden=16, no_heads=2,
                                          no_qk_points=2, no_v_points=3, seq_tfmr_num_layers=1,
                                          num_blocks=2)
    raw["train"]["scheduler"].update(patience=0, factor=0.5)
    cfg = root / "small.yaml"
    cfg.write_text(yaml.safe_dump(raw))
    return root, ids, str(cfg)


def _train(setup, *extra):
    root, _, cfg = setup
    return train.main(["--config", cfg, "--structure_dir", str(root / "structs"),
                       "--dataset_dir", str(root / "cache"), "--exclude_names",
                       str(root / "names.txt"), "--logdir", str(root / "logs"), "--device", "cpu",
                       "--batch_size", "2", "--log_freq", "1", *extra])


def _records(run_dir, tag):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["tag"] == tag]


def test_train_cli_with_validation_split_and_resume(setup):
    root, ids, _ = setup
    run = _train(setup, "--val_dataset_name", "val", "--val_structure_dir", str(root / "val"),
                 "--max_iters", "4", "--val_freq", "2", "--tag", "val")
    log = open(os.path.join(run, "log.txt")).read()
    assert "val it 2 |" in log and "val it 4 |" in log
    train_recs, val_recs = _records(run, "train"), _records(run, "val")
    assert [r["step"] for r in train_recs] == [1, 2, 3, 4] and len(val_recs) == 2
    assert all(np.isfinite(r[k]) for r in train_recs + val_recs for k in r if k.endswith("loss"))
    assert sorted(os.listdir(os.path.join(run, "checkpoints"))) == ["2.pt", "4.pt"]
    assert open(os.path.join(run, "commit.txt")).read().strip()
    # the training cache holds all but the excluded id; validation reads its own
    ds = dataset.PepDataset(str(root / "structs"), str(root / "cache"), name="pep_pocket_train")
    assert ds.ids == [i for i in ids if i != ids[2]]
    assert len(dataset.PepDataset(str(root / "val"), str(root / "cache"), name="val")) == 3

    resumed = _train(setup, "--val_dataset_name", "val", "--val_structure_dir",
                     str(root / "val"), "--max_iters", "6", "--val_freq", "2", "--tag", "resume",
                     "--resume", os.path.join(run, "checkpoints"))
    log = open(os.path.join(resumed, "log.txt")).read()
    assert "at iteration 5" in log and "val it 6 |" in log
    assert [r["step"] for r in _records(resumed, "train")] == [5, 6]
    assert sorted(os.listdir(os.path.join(resumed, "checkpoints"))) == ["6.pt"]


def test_scheduler_steps_on_training_loss_without_validation(setup):
    """No validation split: at each log line the port's scheduler takes the
    training loss, and the learning rates it logs are those JAX's scheduler
    gives on the same losses (patience 0, factor 0.5). ``--profile_dir``
    writes the trace of iterations 11 to 15."""
    root = setup[0]
    run = _train(setup, "--max_iters", "16", "--val_freq", "100", "--tag", "noval",
                 "--profile_dir", str(root / "trace"))
    recs = _records(run, "train")
    assert len(recs) == 16 and not _records(run, "val")
    trace = json.load(open(root / "trace" / "trace.json"))
    assert any("train_step" in e.get("name", "") or "aten::" in e.get("name", "")
               for e in trace["traceEvents"])
    sched, lr = JaxPlateau(factor=0.5, patience=0, min_lr=5e-6), 5e-4
    for r in recs:
        assert r["lr"] == pytest.approx(lr, rel=1e-12), (r["step"], r["lr"], lr)
        lr = sched.step(r["loss"], lr)
    assert len({r["lr"] for r in recs}) > 1      # the rate did move


def jax_noise(jmodel, params, key, B, L):
    """The JAX loss's corruption draws under `key`, in its order (as in
    tests/test_torch_train.py)."""
    key = jmodel.apply({"params": params}, method=lambda m: m.make_rng("corruption"),
                       rngs={"corruption": key})

    @jax.jit
    def draws(key):
        k_t, k_trans, k_rot, k_ang, k_seq, k_seqsamp, k_predsamp = jax.random.split(key, 7)
        return {"t": jax.random.uniform(k_t, (B, 1)),
                "trans_0": jax.random.normal(k_trans, (B, L, 3)),
                "rotmats_0": jso3.uniform_so3(k_rot, (B, L)),
                "angles_0": jtorus.random_uniform(k_ang, (B, L, 5)),
                "seqs_0": jax.random.normal(k_seq, (B, L, 20)),
                "gumbel_seqs_t": jax.random.gumbel(k_seqsamp, (B, L, 20)),
                "gumbel_pred": jax.random.gumbel(k_predsamp, (B, L, 20))}

    return draws(key)


def test_first_real_batch_loss_matches_jax(setup, golden):
    root, _, _ = setup
    structs, cache = str(root / "structs"), str(root / "cache")
    ds = dataset.PepDataset(structs, cache, name="first", n_jobs=1)
    jds = jax_dataset.PepDataset(structs, cache, name="first")
    bnp = next(iter(dataset.DataLoader(ds, batch_size=2, shuffle=True, seed=114514)))
    jb = next(iter(jax_dataset.DataLoader(jds, batch_size=2, shuffle=True, seed=114514)))
    assert not bnp["res_mask"].all()            # padding rows in the batch
    for k, v in jb.items():
        np.testing.assert_array_equal(bnp[k], v, err_msg=k)

    g = golden("model_parity")
    nb = int(g["num_blocks"])
    sd = {k[4:]: np.asarray(g[k], np.float32) for k in g.files if k.startswith("sd::")}
    B, L = bnp["aa"].shape
    jmodel = JaxFlowModel(JaxFlowModelConfig(ipa=JaxIPAConfig(num_blocks=nb)))
    params = convert_state_dict(sd, num_blocks=nb, seq_tfmr_num_layers=2)
    key = jax.random.PRNGKey(3)
    total, losses = jax.jit(make_loss_fn(jmodel, WEIGHTS))(
        params, {k: jnp.asarray(v) for k, v in jb.items()}, key)
    noise = {k: torch.from_numpy(np.array(v)) for k, v in jax_noise(jmodel, params, key, B,
                                                                    L).items()}
    model = build_model(FlowModelConfig(ipa=IPAConfig(num_blocks=nb)), "cpu", state_dict=sd)
    with torch.no_grad():
        ours_total, ours = loss_and_total(model.train(), device_batch(bnp, "cpu"), WEIGHTS,
                                          noise=noise)
    for name, v in losses.items():
        np.testing.assert_allclose(float(ours[name]), float(v), rtol=1e-4, err_msg=name)
    np.testing.assert_allclose(float(ours_total), float(total), rtol=1e-4)
