"""The port's FSDP step (``parallel/fsdp.py``) over gloo ranks on the CPU
against the JAX package's ``make_fsdp_train_step``.

Tiny widths (c_s 32, c_z 16, two blocks, so one EdgeTransition), B=8,
L=16, weights from the JAX model's init through
``convert.state_dict_from_flax``, and JAX's corruption draws of each
step's key injected as the global batch's noise. Two data ranks take two
steps against JAX on a 2-device mesh, at JAX's own bounds
(``tests/test_fsdp.py:35``): the losses within rtol 1e-4 of JAX's, and the
parameters within 2e-4 of JAX's clipped Adam run on the port's own reduced
gradients and of JAX's FSDP step itself, and each step's reduced
gradients, per parameter, within the train-step tolerance of the gradient
of JAX's loss at the weights that step started from. The direct check of
the parameters leaves out the leaves whose JAX gradient is nought to
rounding at some step (not zero, and at most float32's epsilon times the
global norm): Adam's first steps scale such a gradient to ~lr in both
packages, in directions that rounding decides (an EdgeTransition's final
bias, in front of its LayerNorm, parts by ~1e-3); their gaps are printed. Each rank holds ⌈N/2⌉ elements
of the parameters, of each Adam moment and of the reduced gradients, and
no whole parameter storage between steps (``tests/test_fsdp.py:58``'s
claim). FSDP × TP on 2 × 2 ranks against the port's single-process step
per parameter and against ``make_fsdp_train_step(tp_axis="model")``'s loss
(``tests/test_fsdp.py:125``). The port's ranks run on a thread while JAX
compiles.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_grid_ranks as R
from test_torch_train import jax_noise
from pepflowww_tpu.convert import convert_state_dict
from pepflowww_tpu.data.synthetic import make_batch
from pepflowww_tpu.models.flow import FlowModel as JaxFlowModel
from pepflowww_tpu.models.flow import FlowModelConfig as JaxFlowModelConfig
from pepflowww_tpu.models.trunk import IPAConfig as JaxIPAConfig
from pepflowww_tpu.parallel.fsdp import make_fsdp_train_step
from pepflowww_tpu.parallel.mesh import make_mesh
from pepflowww_tpu.parallel.tp import make_mesh_2d
from pepflowww_tpu.training.optim import make_optimizer, zero_nans
from pepflowww_tpu.training.train_step import make_loss_fn

from pepflowww_torch.convert import state_dict_from_flax
from pepflowww_torch.parallel import dist

torch.set_num_threads(1)
IPA = dict(c_s=32, c_z=16, c_hidden=8, no_heads=2, no_qk_points=2, no_v_points=3,
           seq_tfmr_num_heads=2, seq_tfmr_num_layers=1, num_blocks=2)
WIDTHS = (IPA, 32, 16)
KEYS = (5, 6)
# The train-step tolerance of the port's gradients (tests/test_torch_train.py).
STEP_REL, STEP_ABS = 2e-3, 1e-5


def jax_setup():
    """The JAX model, its parameters and optimizer, the numpy batch, the
    port's state dict of the same weights and JAX's draws of each key."""
    jmodel = JaxFlowModel(JaxFlowModelConfig(node_embed_size=32, edge_embed_size=16,
                                             ipa=JaxIPAConfig(**IPA)))
    batch = make_batch(np.random.default_rng(1), batch_size=8, pep_len=4, rec_len=8, pad_to=16)
    batch = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jax.jit(jmodel.init)({"params": jax.random.PRNGKey(0),
                                   "corruption": jax.random.PRNGKey(1)}, jbatch)["params"]
    sd = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params), num_blocks=2,
                              seq_tfmr_num_layers=1)
    B, L = batch["aa"].shape
    noises = [{k: np.array(v) for k, v in
               jax_noise(jmodel, params, jax.random.PRNGKey(k), B, L).items()} for k in KEYS]
    tx = make_optimizer({"type": "adam", "lr": 1e-3}, 100.0)
    return {"jmodel": jmodel, "params": params, "tx": tx, "batch": batch, "jbatch": jbatch,
            "sd": sd, "noises": noises}


def jax_fsdp(s, mesh, steps, tp_axis=None):
    """JAX's FSDP step on `mesh`, `steps` times: (each step's metrics, the
    parameters after the last)."""
    step, prepare = make_fsdp_train_step(s["jmodel"], s["tx"], R.WEIGHTS, mesh, tp_axis=tp_axis)
    pb = jax.device_put(s["jbatch"], NamedSharding(mesh, P("data")))
    params = jax.tree_util.tree_map(jnp.array, s["params"])
    p, o = prepare(params, s["tx"].init(params))
    metrics = []
    for k in KEYS[:steps]:
        p, o, m = step(p, o, pb, jax.random.PRNGKey(k))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, state_dict_from_flax(jax.tree_util.tree_map(np.asarray, p), num_blocks=2,
                                         seq_tfmr_num_layers=1)


def jax_adam(s, grads):
    """JAX's clipped Adam from the initial parameters over the port's
    gradients of each step (state dicts), as the port's names."""
    tx = s["tx"]
    buffers = {k: v for k, v in s["sd"].items() if k.endswith("freq_bands")}
    p = s["params"]
    o = tx.init(p)
    update = jax.jit(lambda g, o, p: tx.update(g, o, p))
    for g in grads:
        jg = convert_state_dict({**g, **buffers}, num_blocks=2, seq_tfmr_num_layers=1)
        u, o = update(jg, o, p)
        p = optax.apply_updates(p, u)
    return state_dict_from_flax(jax.tree_util.tree_map(np.asarray, p), num_blocks=2,
                                seq_tfmr_num_layers=1)


def jax_grads(s, sd, key):
    """The gradient of JAX's loss (``make_loss_fn`` on the whole batch with
    the draws of `key`, non-finite entries zeroed as JAX's steps zero them)
    at the port's parameters `sd`, as the port's names, and its global norm."""
    if "loss_grad" not in s:
        loss = make_loss_fn(s["jmodel"], R.WEIGHTS)
        s["loss_grad"] = jax.jit(lambda p, b, k: zero_nans(
            jax.grad(lambda p: loss(p, b, k)[0])(p)))
    buffers = {k: v for k, v in s["sd"].items() if k.endswith("freq_bands")}
    params = convert_state_dict({**sd, **buffers}, num_blocks=2, seq_tfmr_num_layers=1)
    g = s["loss_grad"](params, s["jbatch"], jax.random.PRNGKey(key))
    grads = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, g), num_blocks=2,
                                 seq_tfmr_num_layers=1)
    return grads, float(optax.global_norm(g))


def assert_grads_match_jax(s, r, first=0):
    """Rank result `r`'s reduced gradient of each step against JAX's at the
    weights that step started from (the initial ones, then the rank's own
    after the step before), within the train-step tolerance. Returns the
    largest share of its bound that any parameter's gap takes."""
    worst = 0.0
    for i, got in enumerate(r["grads"]):
        weights = {k: v for k, v in s["sd"].items() if k in got} if i == 0 else r["after"][i - 1]
        want, G = jax_grads(s, weights, KEYS[first + i])
        for n, g in want.items():
            if n not in got:
                continue
            bound = STEP_REL * np.linalg.norm(g) + STEP_ABS * G
            err = np.linalg.norm(got[n] - g)
            assert err <= bound, (i, n, err, bound)
            worst = max(worst, err / bound)
    return worst


def port_runs(s, out):
    """The port's ranks: one process (two steps, and one), two data ranks
    (two steps), 2 data x 2 model ranks (one step)."""
    args = (s["sd"], WIDTHS, s["batch"])
    single = dist.launch(R.run, 1, (1, [("steps", (*args, s["noises"], False)),
                                        ("steps", (*args, s["noises"][:1], False))]))[0]
    out["single"], out["single1"] = single
    out["fsdp"] = [r[0] for r in dist.launch(R.run, 2, (1, [("steps", (*args, s["noises"],
                                                                        True))]))]
    out["fsdp_tp"] = [r[0] for r in dist.launch(R.run, 4, (2, [("steps", (*args,
                                                                           s["noises"][:1],
                                                                           True))]))]


@pytest.fixture(scope="module")
def runs():
    s = jax_setup()
    port, failed = {}, []

    def target():
        try:
            port_runs(s, port)
        except BaseException as e:   # re-raised below, in the test's thread
            failed.append(e)

    thread = threading.Thread(target=target)
    thread.start()
    jm, jp = jax_fsdp(s, make_mesh(2), 2)
    jm_tp, _ = jax_fsdp(s, make_mesh_2d(2, 2), 1, tp_axis="model")
    thread.join()
    if failed:
        raise failed[0]
    return {**s, **port, "jax": jm, "jax_params": jp, "jax_tp": jm_tp[0],
            "jax_on_port": jax_adam(s, port["fsdp"][0]["grads"])}


def test_fsdp_step_matches_jax(runs):
    """Both ranks, two steps: each step's losses and ``grad_norm`` against
    JAX's at rtol 1e-4; each step's reduced gradients, per parameter,
    against the gradient of JAX's loss at the weights that step started
    from, within the train-step tolerance; the parameters after the second
    step within 2e-4 of JAX's clipped Adam on the rank's own gradients, and
    of JAX's FSDP step's on every leaf whose gradient is not rounding."""
    for r in runs["fsdp"]:
        share = assert_grads_match_jax(runs, r)
        for m, jm in zip(r["metrics"], runs["jax"]):
            for name in [k for k in jm if k.endswith("_loss")] + ["loss", "grad_norm"]:
                np.testing.assert_allclose(m[name], jm[name], rtol=1e-4, err_msg=name)
        worst = max(float(np.abs(p - runs["jax_on_port"][n]).max())
                    for n, p in r["params"].items())
        # Leaves whose JAX gradient is nought to rounding at some step: not
        # zero, and no larger than float32's epsilon times the global norm.
        # Adam's first steps scale such a gradient to ~lr in either package,
        # in directions that rounding decides.
        rounding = set()
        for i in range(len(r["grads"])):
            weights = r["after"][i - 1] if i else {k: v for k, v in runs["sd"].items()
                                                   if k in r["params"]}
            want, G = jax_grads(runs, weights, KEYS[i])
            rounding |= {n for n, g in want.items()
                         if 0 < np.linalg.norm(g) <= np.finfo(np.float32).eps * G}
        gaps = {n: float(np.abs(p - runs["jax_params"][n]).max()) for n, p in r["params"].items()}
        direct = max(g for n, g in gaps.items() if n not in rounding)
        print(f"data rank {r['data_rank']}: losses {[m['loss'] for m in r['metrics']]} vs JAX "
              f"{[m['loss'] for m in runs['jax']]}; gradients within {share:.3f} of their "
              f"bound of JAX's; parameters after two steps within {worst:.3e} of JAX's Adam "
              f"on these gradients, {direct:.3e} of JAX's FSDP step on the {len(gaps) - len(rounding)} "
              f"leaves whose gradient is not rounding, on the others "
              f"{ {n: f'{gaps[n]:.1e}' for n in sorted(rounding)} }")
        assert worst < 2e-4
        assert direct < 2e-4


def test_fsdp_state_is_sharded_per_rank(runs):
    """After ``prepare`` and after each step: ⌈N/2⌉ elements of the
    parameters, of each moment and of the reduced gradients on each rank
    (plus the gaps that start each parameter on a 128-byte boundary: fewer
    than 32 elements a parameter), and no storage behind the parameters
    themselves."""
    for r in runs["fsdp"]:
        N, span = r["numel"], r["span"]
        assert N == sum(p.size for p in runs["single"]["params"].values())
        assert N <= span < N + 32 * r["n_params"]
        half = -(-span // 2)
        first, *after = r["sizes"]
        assert first == {"params": 0, "block": half, "moments": [], "grad_block": None}
        for held in after:
            assert held == {"params": 0, "block": half, "moments": [half, half],
                            "grad_block": half}, held


def test_fsdp_matches_the_single_process_per_parameter(runs):
    """Each rank's losses and reduced gradients of both steps against one
    process's: the losses within rtol 1e-5, every parameter's gradient
    within the train-step tolerance. (The parameters are held in
    :func:`test_fsdp_step_matches_jax`: gradients that are zero but for
    rounding, such as the key bias's under the softmax, make Adam's first
    steps part two processes by ~lr.)"""
    want = runs["single"]
    for r in runs["fsdp"]:
        for m, wm in zip(r["metrics"], want["metrics"]):
            np.testing.assert_allclose(m["loss"], wm["loss"], rtol=1e-5)
        for got, wg in zip(r["grads"], want["grads"]):
            G = np.linalg.norm([np.linalg.norm(g) for g in wg.values()])
            for n, g in wg.items():
                err = np.linalg.norm(got[n] - g)
                assert err <= STEP_REL * np.linalg.norm(g) + STEP_ABS * G, (n, err)


def test_fsdp_tp_matches_single_process_and_jax(runs):
    """2 data x 2 model ranks, one step: every rank's gradients against one
    process's, the loss against JAX's
    ``make_fsdp_train_step(tp_axis="model")`` on a (2, 2) mesh."""
    want = runs["single1"]
    G = np.linalg.norm([np.linalg.norm(g) for g in want["grads"][0].values()])
    assert sorted((r["data_rank"], r["model_rank"]) for r in runs["fsdp_tp"]) == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    for r in runs["fsdp_tp"]:
        np.testing.assert_allclose(r["metrics"][0]["loss"], runs["jax_tp"]["loss"], rtol=1e-4)
        np.testing.assert_allclose(r["metrics"][0]["loss"], want["metrics"][0]["loss"],
                                   rtol=1e-5)
        assert r["sizes"][-1]["block"] == -(-r["span"] // 2)
        for n, g in want["grads"][0].items():
            err = np.linalg.norm(r["grads"][0][n] - g)
            assert err <= STEP_REL * np.linalg.norm(g) + STEP_ABS * G, (n, err)
