"""The port's GPipe pipeline parallelism (``parallel/pp.py``) over gloo
ranks on the CPU against the JAX package's ``make_pp_train_step`` and the
port's own single process.

The trunk runs at the widths of ``tests/test_pp.py::tiny_deep`` (c_s 32,
c_z 16) with four blocks, so that four stages hold one block each; the
steps at ``tests/test_torch_fsdp.py``'s widths, batch (B=8, L=16) and
weights (the JAX model's init through ``convert.state_dict_from_flax``;
two blocks, one a stage), with JAX's corruption draws of ``PRNGKey(5)``
injected as the global batch's noise.

* ``GAEncoder.prologue`` → ``block`` for every b → ``epilogue`` is bitwise
  ``GAEncoder.forward`` (``tests/test_pp.py:67``).
* The pipelined trunk is within atol 1e-5 of the port's forward at
  (n_data, n_pipe, M) = (1, 2, 1), (1, 2, 4), (1, 4, 2) and (2, 2, 2)
  (``tests/test_pp.py:101``): fill and drain with one microbatch, more
  microbatches than stages, one block a stage, data x pipe.
* One step on one data x two pipe ranks, M=2, against
  ``make_pp_train_step(…, make_mesh_pp(1, 2), n_micro=2)``: the loss within
  rtol 1e-4, each loss within 2e-4, the parameters within 1e-5
  (``tests/test_pp.py:129``), and every gradient within the train-step
  tolerance of one process's and of the gradient of JAX's loss.
* ``--pp --fsdp`` on 2 x 2 ranks against ``make_pp_train_step(…,
  make_mesh_pp(2, 2), n_micro=2, fsdp=True)``: the same bounds, the
  parameters against JAX's on the leaves whose JAX gradient is not nought
  to rounding (``tests/test_torch_fsdp.py``'s rule) and within 1e-5 of the
  port's single process on every leaf; each rank holds half the state.
* Before the reduce, every parameter's gradient is non-zero on at most
  one stage of a pipe group, the one ``pp.stage_parameters`` names.

The port's ranks run on a thread while JAX compiles.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_grid_ranks as R
from test_torch_fsdp import STEP_ABS, STEP_REL, WIDTHS, jax_grads, jax_setup
from pepflowww_tpu.parallel.mesh import replicate
from pepflowww_tpu.parallel.pp import make_mesh_pp
from pepflowww_tpu.training.train_step import make_pp_train_step

from pepflowww_torch.convert import state_dict_from_flax
from pepflowww_torch.models.flow import FlowModel, FlowModelConfig, init_weights
from pepflowww_torch.models.trunk import GAEncoder, IPAConfig
from pepflowww_torch.parallel import dist

torch.set_num_threads(1)
# The trunk's widths: four blocks.
IPA = {**WIDTHS[0], "num_blocks": 4}
KEY, M = 5, 2
# (n_data, n_pipe, M) of the pipelined trunk, by launch.
TRUNK = {2: [(1, 2, 1), (1, 2, 4)], 4: [(1, 4, 2), (2, 2, 2)]}


def trunk_state(B=8, L=12):
    """GAEncoder's inputs (``tests/test_pp.py::_trunk_inputs``' kinds), from numpy."""
    rng = np.random.default_rng(4)
    f32 = np.float32
    return [rng.uniform(size=(B, 1)).astype(f32), np.tile(np.eye(3, dtype=f32), (B, L, 1, 1)),
            rng.normal(size=(B, L, 3)).astype(f32),
            (rng.uniform(size=(B, L, 5)) * 2 * np.pi).astype(f32),
            rng.integers(0, 20, (B, L)), rng.normal(size=(B, L, 32)).astype(f32),
            rng.normal(size=(B, L, L, 16)).astype(f32), np.ones((B, L), np.int64),
            np.ones((B, L), np.int64)]


def jax_runs(s) -> dict:
    """JAX's pipelined step on (1, 2) and, with FSDP, on (2, 2), and the
    gradient of JAX's loss at the initial weights with its global norm."""
    out = {}
    for tag, (nd, fsdp) in {"pp": (1, False), "pp_fsdp": (2, True)}.items():
        mesh = make_mesh_pp(nd, 2)
        pb = jax.device_put(s["jbatch"], NamedSharding(mesh, P("data")))
        params = jax.tree_util.tree_map(jnp.array, s["params"])
        step = make_pp_train_step(s["jmodel"], s["tx"], R.WEIGHTS, mesh, n_micro=M, fsdp=fsdp)
        if fsdp:
            step, prepare = step
            p, o = prepare(params, s["tx"].init(params))
        else:
            p, o = replicate(params, mesh), replicate(s["tx"].init(params), mesh)
        p, _, m = step(p, o, pb, jax.random.PRNGKey(KEY))
        out[tag] = {"metrics": {k: float(v) for k, v in m.items()},
                    "params": state_dict_from_flax(jax.tree_util.tree_map(np.asarray, p),
                                                   num_blocks=2, seq_tfmr_num_layers=1)}
    out["loss_grad"], out["loss_grad_norm"] = jax_grads(s, s["sd"], KEY)
    return out


def port_runs(s, out):
    """One process; two ranks (1 x 2: the trunk at M=1 and 4, the step, the
    gradients' owners); four ranks (the trunk at 1 x 4 and 2 x 2, the
    --pp --fsdp step at 2 x 2)."""
    state = trunk_state()
    args = (s["sd"], WIDTHS, s["batch"])
    noise = s["noises"][0]
    out["single"] = dist.launch(R.run, 1, (1, [("steps", (*args, [noise], False))]))[0][0]
    calls = {w: [("trunk", (IPA, state, n_micro), (1, n_pipe)) for _, n_pipe, n_micro in grids]
             for w, grids in TRUNK.items()}
    two = dist.launch(R.run, 2, (1, calls[2] + [
        ("steps", (*args, [noise], False, False, M)),
        ("ownership", (*args, noise, M))]))
    four = dist.launch(R.run, 4, (1, calls[4] + [
        ("steps", (*args, [noise], True, False, M), (1, 2))]))
    out["trunk"] = {2: [r[:2] for r in two], 4: [r[:2] for r in four]}
    out["pp"] = [r[2] for r in two]
    out["ownership"] = [r[3] for r in two]
    out["pp_fsdp"] = [r[2] for r in four]


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
    j = jax_runs(s)
    thread.join()
    if failed:
        raise failed[0]
    return {**s, **port, "jax": j}


def test_decomposition_is_bitwise_forward():
    torch.manual_seed(0)
    model = FlowModel(FlowModelConfig(node_embed_size=32, edge_embed_size=16,
                                      ipa=IPAConfig(**IPA)))
    gen = torch.Generator().manual_seed(3)
    init_weights(model, gen)
    enc = model.ga_encoder
    with torch.no_grad():
        for p in enc.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=gen))
        args = [torch.from_numpy(v) for v in trunk_state()]
        want = enc(*args)
        t, rot, trans, angles, seqs, node, edge, _, res = args
        state = enc.prologue(t, rot, trans, angles, seqs, node, edge, res)
        for b in range(IPA["num_blocks"]):
            state, readouts = enc.block(b, state)
            assert readouts is None
        got = enc.epilogue(state)
    assert isinstance(enc, GAEncoder) and len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("world", sorted(TRUNK))
def test_pipelined_trunk_matches_forward(runs, world):
    """Each launch's two grids; on every last stage (one a data rank) each
    output within atol 1e-5 of the port's forward on that data rank's rows."""
    for i, (nd, n_pipe, n_micro) in enumerate(TRUNK[world]):
        got = [r[i] for r in runs["trunk"][world] if r[i] is not None]
        assert sorted(g["data_rank"] for g in got) == list(range(nd)), (nd, n_pipe, n_micro)
        for g in got:
            assert g["stages"] == n_pipe
            assert max(g["gaps"]) <= 1e-5, (nd, n_pipe, n_micro, g["gaps"])


def _grad_gaps(got: dict, want: dict, G: float) -> float:
    """The largest share of its train-step bound that a parameter's gradient gap takes."""
    worst = 0.0
    for n, g in want.items():
        bound = STEP_REL * np.linalg.norm(g) + STEP_ABS * G
        err = np.linalg.norm(got[n] - g)
        assert err <= bound, (n, err, bound)
        worst = max(worst, err / bound)
    return worst


def _check_step(runs, tag: str, rounding_rule: bool):
    j = runs["jax"][tag]
    single = runs["single"]
    Gs = float(np.linalg.norm([np.linalg.norm(g) for g in single["grads"][0].values()]))
    jg = {n: g for n, g in runs["jax"]["loss_grad"].items() if n in single["grads"][0]}
    G = runs["jax"]["loss_grad_norm"]
    rounding = {n for n, g in jg.items()
                if 0 < np.linalg.norm(g) <= np.finfo(np.float32).eps * G} if rounding_rule else set()
    for r in runs[tag]:
        m = r["metrics"][0]
        np.testing.assert_allclose(m["loss"], j["metrics"]["loss"], rtol=1e-4)
        for name in [k for k in j["metrics"] if k.endswith("_loss")]:
            np.testing.assert_allclose(m[name], j["metrics"][name], rtol=2e-4, err_msg=name)
        share_single = _grad_gaps(r["grads"][0], single["grads"][0], Gs)
        share_jax = _grad_gaps(r["grads"][0], jg, G)
        gaps = {n: float(np.abs(p - j["params"][n]).max()) for n, p in r["params"].items()}
        direct = max(g for n, g in gaps.items() if n not in rounding)
        to_single = max(float(np.abs(p - single["params"][n]).max())
                        for n, p in r["params"].items())
        print(f"{tag} rank (data {r['data_rank']}, pipe {r['pipe_rank']}): loss {m['loss']:.7f}, "
              f"JAX {j['metrics']['loss']:.7f}; gradients within {share_single:.3f} of their "
              f"bound of one process's, {share_jax:.3f} of JAX's; parameters {direct:.3e} "
              f"from JAX's step on {len(gaps) - len(rounding)} leaves (rounding: "
              f"{ {n: f'{gaps[n]:.1e}' for n in sorted(rounding)} }), {to_single:.3e} from "
              f"one process's")
        assert direct < 1e-5
        assert to_single < 1e-5
    return runs[tag]


def test_pp_step_matches_jax_and_the_single_process(runs):
    ranks = _check_step(runs, "pp", rounding_rule=False)
    assert sorted((r["data_rank"], r["pipe_rank"]) for r in ranks) == [(0, 0), (0, 1)]


def test_pp_fsdp_step_matches_jax_and_holds_half_the_state(runs):
    ranks = _check_step(runs, "pp_fsdp", rounding_rule=True)
    assert sorted((r["data_rank"], r["pipe_rank"]) for r in ranks) == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    for r in ranks:
        half = -(-r["span"] // 2)
        assert r["sizes"][-1] == {"params": 0, "block": half, "moments": [half, half],
                                  "grad_block": half}, r["sizes"]


def test_each_gradient_comes_from_one_stage(runs):
    """Before the reduce: the parameters with a non-zero gradient on each
    stage are among those ``pp.stage_parameters`` gives it, the two
    stages' sets are disjoint and together every parameter; the losses are
    on the last stage only."""
    first, last = sorted(runs["ownership"], key=lambda r: r["pipe_rank"])
    names = set(first["names"])
    assert set(first["owned"]) | set(last["owned"]) == names
    assert not set(first["owned"]) & set(last["owned"])
    for r in (first, last):
        assert set(r["nonzero"]) <= set(r["owned"]), set(r["nonzero"]) - set(r["owned"])
    assert any("node_embedder" in n for n in first["nonzero"])
    assert any("trunk.ipa_1" in n for n in last["nonzero"])
    assert any("seq_net" in n for n in last["nonzero"])
    assert first["losses"] is None and np.isfinite(list(last["losses"].values())).all()
    print(f"non-zero gradients: stage 0 {len(first['nonzero'])} of its {len(first['owned'])}, "
          f"stage 1 {len(last['nonzero'])} of its {len(last['owned'])} parameters")
