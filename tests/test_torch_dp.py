"""The port's data-parallel step and sampler over two gloo ranks on the CPU
against the JAX package's DP step on a 2-device CPU mesh.

At golden dims (``model_parity.npz``, nb=2, B=2, fp32, the weights of
tests/test_torch_train.py), rank r holds row r. The global step
(``train_step``), with JAX's global corruption draws injected, against
``make_dp_train_step`` at ``test_one_step_matches_jax``'s tolerances: the
losses, the total and ``grad_norm`` within rtol 1e-4 of JAX's; the
parameters after the step within 1e-6 of JAX's clipped Adam step on the
port's own reduced gradients; and each parameter's reduced gradient within
2e-3 of its norm plus 1e-5 of the global norm of the port's
single-process gradients of the global batch (which
``test_one_step_matches_jax`` holds to JAX's). Then: a non-finite row on
one rank zeroes the step on both ranks; two runs give the same gradients
bit for bit, equal on both ranks; and each rank's rows of the DP sampler
are a single-process ``euler_sample`` of those rows with that rank's
generator, bit for bit, as tests/test_manual.py pins JAX's manual sampler.
The manual step: tests/test_torch_dp_manual.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_dp_ranks
from test_torch_train import jax_noise
from pepflowww_tpu.convert import convert_state_dict
from pepflowww_tpu.models.flow import FlowModel as JaxFlowModel
from pepflowww_tpu.models.flow import FlowModelConfig as JaxFlowModelConfig
from pepflowww_tpu.models.trunk import IPAConfig as JaxIPAConfig
from pepflowww_tpu.parallel.mesh import make_mesh, replicate, shard_batch
from pepflowww_tpu.training import optim as joptim
from pepflowww_tpu.training.train_step import make_dp_train_step

from pepflowww_torch.convert import state_dict_from_flax
from pepflowww_torch.data.collate import device_batch
from pepflowww_torch.parallel import dist, dp
from pepflowww_torch.training.optim import zero_nans
from pepflowww_torch.training.train_step import loss_and_total

torch.set_num_threads(1)
WEIGHTS = torch_dp_ranks.WEIGHTS
LR = 1e-3


def golden_setup(golden):
    """The weights, batch, JAX model, parameters, optimizer and 2-device
    mesh of the DP tests, and JAX's clipped Adam step."""
    g = golden("model_parity")
    nb = int(g["num_blocks"])
    rng = np.random.default_rng(21)
    sd = {k[4:]: np.asarray(g[k], np.float32) for k in g.files if k.startswith("sd::")}
    sd = {k: v if k.endswith("freq_bands") else v + 0.02 * rng.normal(size=v.shape).astype(np.float32)
          for k, v in sd.items()}
    bnp = {k[6:]: np.asarray(g[k]) for k in g.files if k.startswith("batch_")}
    assert bnp["aa"].shape[0] == 2
    jmodel = JaxFlowModel(JaxFlowModelConfig(ipa=JaxIPAConfig(num_blocks=nb)))
    params = convert_state_dict(sd, num_blocks=nb, seq_tfmr_num_layers=2)
    tx = joptim.make_optimizer({"type": "adam", "lr": LR}, 100.0)
    adam_step = jax.jit(lambda gr, p: optax.apply_updates(p, tx.update(gr, tx.init(p), p)[0]))
    return {"nb": nb, "sd": sd, "batch": bnp, "jmodel": jmodel, "params": params, "tx": tx,
            "mesh": make_mesh(2), "adam_step": adam_step, "key": jax.random.PRNGKey(7),
            "jbatch": {k: jnp.asarray(v) for k, v in bnp.items()}}


def np_noise(s, key, B):
    """JAX's corruption draws of `B` rows under `key`, as numpy."""
    L = s["batch"]["aa"].shape[1]
    return {n: np.array(v) for n, v in jax_noise(s["jmodel"], s["params"], key, B, L).items()}


def check_step(s, rank_out, want_m, want_g, kind):
    """One rank's step against JAX's metrics `want_m`, the gradients
    `want_g` and JAX's clipped Adam step on the rank's own gradients."""
    m, grads, params = rank_out
    for name in [k for k in want_m if k.endswith("_loss")] + ["loss", "grad_norm"]:
        np.testing.assert_allclose(m[name], want_m[name], rtol=1e-4, err_msg=f"{kind} {name}")
    G = np.linalg.norm([np.linalg.norm(g) for g in want_g.values()])
    for name, got in grads.items():
        err = np.linalg.norm(got - want_g[name])
        assert err <= 2e-3 * np.linalg.norm(want_g[name]) + 1e-5 * G, (kind, name, err)
    buffers = {k: v for k, v in s["sd"].items() if k.endswith("freq_bands")}
    jg = convert_state_dict({**grads, **buffers}, num_blocks=s["nb"], seq_tfmr_num_layers=2)
    want_p = state_dict_from_flax(jax.tree_util.tree_map(
        np.asarray, s["adam_step"](jg, s["params"])), num_blocks=s["nb"])
    for name, p in params.items():
        np.testing.assert_allclose(p, want_p[name], atol=1e-6, err_msg=f"{kind} {name}")


@pytest.fixture(scope="module")
def runs(golden):
    """JAX's DP step, the port's single-process gradients of the global
    batch, and the port's two ranks, on the same weights, batch and draws."""
    s = golden_setup(golden)
    mesh, params, tx = s["mesh"], s["params"], s["tx"]
    _, _, m = make_dp_train_step(s["jmodel"], tx, WEIGHTS, mesh)(
        replicate(params, mesh), replicate(tx.init(params), mesh),
        shard_batch(s["jbatch"], mesh), s["key"])
    noise = np_noise(s, s["key"], 2)
    model = torch_dp_ranks._model(s["sd"], s["nb"])
    total, _ = loss_and_total(model, device_batch(s["batch"], "cpu"), WEIGHTS,
                              noise={k: torch.from_numpy(v) for k, v in noise.items()})
    total.backward()
    zero_nans(model.parameters())
    single = {n: p.grad.numpy() for n, p in model.named_parameters()}
    three = {k: np.concatenate([v, v[:1]]) for k, v in s["batch"].items()}
    ranks = dist.launch(torch_dp_ranks.train_steps, 2, (s["sd"], s["nb"], s["batch"], noise, 1,
                                                         False, (three, 5, 3)))
    assert [r["rank"] for r in ranks] == [0, 1]
    return {**s, "jax": {k: float(v) for k, v in m.items()}, "single": single, "ranks": ranks,
            "three": three}


def test_dp_step_matches_jax(runs):
    """Both ranks' step against ``make_dp_train_step``."""
    for r in runs["ranks"]:
        check_step(runs, r["step"], runs["jax"], runs["single"], "global")


def test_non_finite_row_zeroes_the_step_on_both_ranks(runs):
    """Row 1 (rank 1's) non-finite: every gradient zero on both ranks, a
    zero total and ``grad_norm``, the first Adam step's parameters
    unmoved, although rank 0's own gradients are not zero."""
    assert any(g.any() for g in runs["ranks"][0]["own_bad"].values())
    for r in runs["ranks"]:
        m, grads, params = r["bad"]
        assert m["loss"] == 0.0 and m["grad_norm"] == 0.0
        assert all(not g.any() for g in grads.values())
        for name, p in params.items():
            np.testing.assert_array_equal(p, runs["sd"][name], err_msg=name)


def test_gradients_bit_identical_across_runs_and_ranks(runs):
    base = runs["ranks"][0]["step"][1]
    for r in runs["ranks"]:
        for kind in ("step", "again"):
            for name, g in r[kind][1].items():
                np.testing.assert_array_equal(g, base[name], err_msg=f"rank {r['rank']} {kind}")


def test_dp_sampler_rows_are_single_process_samples(runs):
    """3 rows over 2 ranks (padded to 4 with a copy of the last row): rank
    r's rows of the gathered output equal ``euler_sample`` of those rows
    with ``dp.rank_generator(seed, r)``, run apart in rank r's process, bit
    for bit, and the padding is dropped."""
    got = [r["sample"] for r in runs["ranks"]]
    assert got[1]["gathered"] is None and got[0]["gathered"]["trans"].shape[0] == 3
    padded = dp.pad_rows(device_batch(runs["three"], "cpu"), 2)
    assert padded["aa"].shape[0] == 4 and torch.equal(padded["aa"][3], padded["aa"][2])
    for r in range(2):
        for k, v in got[r]["own"].items():
            assert v.shape[0] == 2
            np.testing.assert_array_equal(got[0]["gathered"][k][2 * r:2 * r + 2],
                                          v[:3 - 2 * r], err_msg=f"rank {r} {k}")
