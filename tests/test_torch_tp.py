"""The port's pair-row TP (``parallel/tp.py``) over gloo ranks on the CPU
against the JAX package's ``make_tp_train_step`` and the port's own single
process.

The widths, weights, batch and draws of tests/test_torch_fsdp.py. One data
x two model ranks take one step against JAX on a ``make_mesh_2d(1, 2)``
mesh: the losses within rtol 1e-4 (``tests/test_tp.py:28``), the
parameters within 1e-5 of JAX's TP step's and of JAX's clipped Adam on
the port's own reduced gradients, and every rank's gradient
of every parameter within the train-step tolerance of one process's and
of the gradient of JAX's loss at the same weights, batch and draws. Every EdgeTransition and
IPA on each of four model ranks receives (B, ⌈L/4⌉, 4⌈L/4⌉, c_z) pair
tensors at L=18 (padded to 20 by masked residues), and the loss there is
the single process's at L=18 (``tests/test_tp.py:50``'s claim: a silent
replication would pass the step's check but not this one). The TP sampler
over one data x two model ranks at L=16, and over four at L=18, 4 steps,
seed 7, gives the port's single-process sampler's trans, rotations and
tokens bit for bit; the
port's generator draws other numbers than JAX's keys, so it is never held
to JAX's sampler draw for draw (``tests/test_tp.py:72`` holds JAX's to its
own single device). A ``use_pallas`` model under TP warns and samples what
the plain model samples (``tests/test_tp.py:112``).
"""

import threading

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_grid_ranks as R
from test_torch_fsdp import (STEP_ABS, STEP_REL, WIDTHS, assert_grads_match_jax, jax_adam,
                             jax_setup)
from test_torch_train import jax_noise
from pepflowww_tpu.data.synthetic import make_batch
from pepflowww_tpu.parallel.mesh import replicate
from pepflowww_tpu.parallel.tp import make_mesh_2d
from pepflowww_tpu.training.train_step import make_tp_train_step

from pepflowww_torch.convert import state_dict_from_flax
from pepflowww_torch.parallel import dist, tp

torch.set_num_threads(1)
SEED, STEPS = 7, 4


def port_runs(s, out):
    """One process; one data x two model ranks; one data x four model ranks at L=18."""
    args = (s["sd"], WIDTHS)
    sample = ("sample", (*args, s["batch"], SEED, STEPS))
    sample18 = ("sample", (*args, s["batch18"], SEED, STEPS))
    out["single"] = dist.launch(R.run, 1, (1, [
        ("steps", (*args, s["batch"], s["noises"][:1], False)), sample,
        ("steps", (*args, s["batch18"], [s["noise18"]], False)), sample18]))[0]
    out["tp"] = dist.launch(R.run, 2, (2, [
        ("steps", (*args, s["batch"], s["noises"][:1], False, True)), sample,
        ("sample", (*args, s["batch"], SEED, STEPS, {"use_pallas": True}))]))
    out["tp4"] = dist.launch(R.run, 4, (4, [
        ("steps", (*args, s["batch18"], [s["noise18"]], False, True)), sample18]))


@pytest.fixture(scope="module")
def runs():
    s = jax_setup()
    s["batch18"] = {k: v for k, v in make_batch(np.random.default_rng(2), batch_size=2,
                                                 pep_len=4, rec_len=12, pad_to=18).items()
                    if isinstance(v, np.ndarray)}
    s["noise18"] = {k: np.array(v) for k, v in
                    jax_noise(s["jmodel"], s["params"], jax.random.PRNGKey(9), 2, 18).items()}
    port, failed = {}, []

    def target():
        try:
            port_runs(s, port)
        except BaseException as e:   # re-raised below, in the test's thread
            failed.append(e)

    thread = threading.Thread(target=target)
    thread.start()
    mesh = make_mesh_2d(1, 2)
    opt0 = s["tx"].init(s["params"])
    jp, _, m = make_tp_train_step(s["jmodel"], s["tx"], R.WEIGHTS, mesh)(
        replicate(s["params"], mesh), replicate(opt0, mesh),
        jax.device_put(s["jbatch"], NamedSharding(mesh, P("data"))), jax.random.PRNGKey(5))
    thread.join()
    if failed:
        raise failed[0]
    return {**s, **port, "jax": {k: float(v) for k, v in m.items()},
            "jax_params": state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jp),
                                               num_blocks=2, seq_tfmr_num_layers=1),
            "jax_on_port": [jax_adam(s, r[0]["grads"]) for r in port["tp"]]}


def test_tp_step_matches_jax_and_the_single_process(runs):
    want = runs["single"][0]
    G = np.linalg.norm([np.linalg.norm(g) for g in want["grads"][0].values()])
    for r, on_port in zip(runs["tp"], runs["jax_on_port"]):
        got = r[0]
        m = got["metrics"][0]
        for name in [k for k in runs["jax"] if k.endswith("_loss")] + ["loss", "grad_norm"]:
            np.testing.assert_allclose(m[name], runs["jax"][name], rtol=1e-4, err_msg=name)
        for n, p in got["params"].items():
            np.testing.assert_allclose(p, on_port[n], atol=1e-5, err_msg=n)
        for n, g in want["grads"][0].items():
            err = np.linalg.norm(got["grads"][0][n] - g)
            assert err <= STEP_REL * np.linalg.norm(g) + STEP_ABS * G, (got["model_rank"], n, err)
        share = assert_grads_match_jax(runs, got)
        direct = max(float(np.abs(p - runs["jax_params"][n]).max())
                     for n, p in got["params"].items())
        print(f"model rank {got['model_rank']}: loss {m['loss']:.7f}, JAX {runs['jax']['loss']:.7f}, "
              f"one process {want['metrics'][0]['loss']:.7f}; gradients within {share:.3f} of "
              f"their bound of JAX's; parameters {direct:.3e} from JAX's TP step's")
        assert direct < 1e-5


def test_pair_tensors_are_row_sharded(runs):
    """Hooks on every EdgeTransition and IPA: (B, L/2, L, c_z) on two model
    ranks at L=16, (B, 5, 20, c_z) on four at L=18; the L=18 step's loss
    and gradients are the single process's."""
    for r in runs["tp"]:
        seen = r[0]["seen"]
        assert len(seen) == 3 and all(shape == (8, 8, 16, 16) for _, shape in seen), seen
    want = runs["single"][2]
    G = np.linalg.norm([np.linalg.norm(g) for g in want["grads"][0].values()])
    assert sorted(r[0]["model_rank"] for r in runs["tp4"]) == [0, 1, 2, 3]
    for r in (r[0] for r in runs["tp4"]):
        assert {name for name, _ in r["seen"]} == {"ga_encoder.trunk.ipa_0",
                                                   "ga_encoder.trunk.ipa_1",
                                                   "ga_encoder.trunk.edge_transition_0"}
        assert all(shape == (2, 5, 20, 16) for _, shape in r["seen"]), r["seen"]
        np.testing.assert_allclose(r["metrics"][0]["loss"], want["metrics"][0]["loss"],
                                   rtol=1e-5)
        for n, g in want["grads"][0].items():
            err = np.linalg.norm(r["grads"][0][n] - g)
            assert err <= STEP_REL * np.linalg.norm(g) + STEP_ABS * G, (n, err)


@pytest.mark.parametrize("where", ["tp", "tp4"])
def test_tp_sampler_is_the_single_process_sampler(runs, where):
    """Two model ranks at L=16; four at L=18, which they pad to 20 while
    the sampler draws at 18."""
    want = runs["single"][1 if where == "tp" else 3]["out"]
    got = runs[where][0][1]["out"]
    assert all(r[1]["out"] is None for r in runs[where][1:])   # only rank 0 gathers
    print("trans gap", float(np.abs(got["trans"] - want["trans"]).max()),
          "tokens differing", int((got["seqs"] != want["seqs"]).sum()))
    np.testing.assert_allclose(got["trans"], want["trans"], atol=5e-5)
    np.testing.assert_allclose(got["rotmats"], want["rotmats"], atol=5e-5)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_pallas_profile_under_tp_warns_and_samples_the_plain_model(runs):
    for r in runs["tp"]:
        assert r[2]["warnings"] == [tp.PROFILE_WARNING]
        assert "Pallas" in r[2]["warnings"][0]
    want = runs["single"][1]["out"]
    for k, v in runs["tp"][0][2]["out"].items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
