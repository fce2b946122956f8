"""The port's manual data-parallel step (``train_step(manual=True)``,
the train CLI's ``--dp_manual``) over two gloo ranks on the CPU against the
JAX package's ``make_manual_dp_train_step`` on a 2-device CPU mesh.

The setup of tests/test_torch_dp.py; each rank's corruption draws are
JAX's under the key folded with its index. The losses, the total and
``grad_norm`` within rtol 1e-4 of JAX's; the parameters after the step
within 1e-6 of JAX's clipped Adam step on the port's own reduced
gradients; each parameter's reduced gradient within 2e-3 of its norm plus
1e-5 of the global norm of the mean of the ranks' own rescued gradients
(the per-shard gradients of JAX's manual step). A non-finite row on rank
1 zeroes rank 1's part only: the reduced gradient is rank 0's own over
two, on both ranks.
"""

import jax
import numpy as np
import pytest
import torch

import torch_dp_ranks
from test_torch_dp import WEIGHTS, check_step, golden_setup, np_noise
from pepflowww_tpu.parallel.manual import make_manual_dp_train_step
from pepflowww_tpu.parallel.mesh import replicate, shard_batch

from pepflowww_torch.parallel import dist

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def runs(golden):
    s = golden_setup(golden)
    mesh, params, tx = s["mesh"], s["params"], s["tx"]
    _, _, m = make_manual_dp_train_step(s["jmodel"], tx, WEIGHTS, mesh)(
        replicate(params, mesh), replicate(tx.init(params), mesh),
        shard_batch(s["jbatch"], mesh), s["key"])
    noise = [np_noise(s, jax.random.fold_in(s["key"], i), 1) for i in range(2)]
    ranks = dist.launch(torch_dp_ranks.train_steps, 2, (s["sd"], s["nb"], s["batch"], noise, 1,
                                                         True))
    assert [r["rank"] for r in ranks] == [0, 1]
    mean_own = {n: (ranks[0]["own"][n] + ranks[1]["own"][n]) / 2 for n in ranks[0]["own"]}
    return {**s, "jax": {k: float(v) for k, v in m.items()}, "mean_own": mean_own,
            "ranks": ranks}


def test_manual_dp_step_matches_jax(runs):
    for r in runs["ranks"]:
        check_step(runs, r["step"], runs["jax"], runs["mean_own"], "manual")


def test_non_finite_row_zeroes_its_own_rank_only(runs):
    own0 = runs["ranks"][0]["own_bad"]
    assert any(g.any() for g in own0.values())
    assert all(np.isfinite(g).all() and not g.any() for g in runs["ranks"][1]["own_bad"].values())
    for r in runs["ranks"]:
        m, grads, _ = r["bad"]
        assert np.isfinite(m["loss"]) and m["grad_norm"] > 0
        for name, g in grads.items():
            np.testing.assert_allclose(g, own0[name] / 2, rtol=1e-6, atol=1e-12, err_msg=name)
