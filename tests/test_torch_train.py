"""The port's training step against the JAX package's.

One step at golden dims (``model_parity.npz``, nb=2, fp32, weights perturbed
off the reference init by seeded noise) with the JAX step's own corruption
draws injected into the port: the six losses, the total and ``grad_norm``
within rtol 1e-4. Each parameter's gradient within 2e-3 of its norm plus
1e-5 of the global gradient norm G: fp32 sums through the whole model run in
another order, and gradients that reach the loss only through the
attention's pair bias are small (norms down to 1e-7 against G ≈ 157) and
carry cancellation error of a fixed absolute size (measured: at most 1.4e-3
relative on parameters with norms above 1, 3e-2 on norms near 1e-3). The
parameters after the port's step within 1e-6 of JAX's clipped Adam step
taken on the port's own gradients: the first Adam step moves an entry by
about lr times the sign of its gradient, so entries whose gradients are
noise-sized would flip in a direct comparison. It runs with the kernels'
plain twins on and off.
Then: 30 Adam steps on one batch and one draw lower the loss; a poisoned
batch leaves the parameters finite; accumulation and the plateau scheduler
step as ``pepflowww_tpu/training/optim.py`` does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pepflowww_tpu.convert import convert_state_dict
from pepflowww_tpu.models.flow import FlowModel as JaxFlowModel
from pepflowww_tpu.models.flow import FlowModelConfig as JaxFlowModelConfig
from pepflowww_tpu.models.trunk import IPAConfig as JaxIPAConfig
from pepflowww_tpu.ops import so3 as jso3
from pepflowww_tpu.ops import torus as jtorus
from pepflowww_tpu.training import optim as joptim
from pepflowww_tpu.training.train_step import make_loss_fn

from pepflowww_torch.convert import state_dict_from_flax
from pepflowww_torch.data.collate import device_batch
from pepflowww_torch.data.synthetic import make_batch
from pepflowww_torch.models.flow import FlowModelConfig, build_model, draw_noise
from pepflowww_torch.models.trunk import IPAConfig
from pepflowww_torch.training.optim import Optimizer, PlateauScheduler
from pepflowww_torch.training.train_step import train_step

torch.set_num_threads(1)
WEIGHTS = {"trans_loss": 0.5, "rot_loss": 0.5, "bb_atom_loss": 0.25,
           "seqs_loss": 1.0, "angle_loss": 1.0, "torsion_loss": 0.5}


def jax_noise(jmodel, params, key, B, L):
    """The draws of the JAX ``loss_pre`` under the ``corruption`` stream
    `key`, in its order (from the key its ``make_rng`` derives); the two
    categorical samples as the Gumbel noise ``jax.random.categorical`` adds."""
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


@pytest.fixture(scope="module")
def jax_step(golden):
    """One JAX step (XLA branch) at golden dims: weights, batch, the injected
    draws, the losses, the gradients and the parameters after one Adam step."""
    g = golden("model_parity")
    nb = int(g["num_blocks"])
    rng = np.random.default_rng(21)
    sd = {k[4:]: np.asarray(g[k], np.float32) for k in g.files if k.startswith("sd::")}
    sd = {k: v if k.endswith("freq_bands") else v + 0.02 * rng.normal(size=v.shape).astype(np.float32)
          for k, v in sd.items()}
    bnp = {k[6:]: np.asarray(g[k]) for k in g.files if k.startswith("batch_")}
    B, L = bnp["aa"].shape
    key = jax.random.PRNGKey(7)
    jmodel = JaxFlowModel(JaxFlowModelConfig(ipa=JaxIPAConfig(num_blocks=nb)))
    params = convert_state_dict(sd, num_blocks=nb, seq_tfmr_num_layers=2)
    @jax.jit
    def step(params, batch, key):
        (total, losses), grads = jax.value_and_grad(make_loss_fn(jmodel, WEIGHTS),
                                                    has_aux=True)(params, batch, key)
        grads = joptim.zero_nans(grads)
        return total, losses, grads, optax.global_norm(grads)

    total, losses, grads, grad_norm = step(params, {k: jnp.asarray(v) for k, v in bnp.items()},
                                           key)
    tx = joptim.make_optimizer({"type": "adam", "lr": 1e-3}, 100.0)
    adam_step = jax.jit(lambda gr, p: optax.apply_updates(p, tx.update(gr, tx.init(p), p)[0]))
    noise = {k: torch.from_numpy(np.array(v))
             for k, v in jax_noise(jmodel, params, key, B, L).items()}
    return {"nb": nb, "sd": sd, "batch": bnp, "noise": noise, "total": float(total),
            "losses": {k: float(v) for k, v in losses.items()},
            "grad_norm": float(grad_norm),
            "grads": state_dict_from_flax(jax.tree_util.tree_map(np.asarray, grads),
                                          num_blocks=nb),
            "params": params, "adam_step": adam_step}


@pytest.mark.parametrize("use_kernels", [False, True])
def test_one_step_matches_jax(jax_step, use_kernels):
    """The port's step, with the kernels' plain twins on and off, against the
    JAX step: the Functions' backward twins are held to JAX's backward
    kernels in tests/test_torch_grad.py, and JAX holds its kernel path to its
    XLA branch in tests/test_pallas.py."""
    j = jax_step
    cfg = FlowModelConfig(ipa=IPAConfig(num_blocks=j["nb"], use_pallas=use_kernels))
    model = build_model(cfg, "cpu", state_dict=j["sd"]).train()
    optimizer = Optimizer(model.parameters(), {"type": "adam", "lr": 1e-3}, 100.0)
    m = train_step(model, optimizer, device_batch(j["batch"], "cpu"), WEIGHTS, noise=j["noise"])

    for name, v in j["losses"].items():
        np.testing.assert_allclose(float(m[name]), v, rtol=1e-4, err_msg=name)
    np.testing.assert_allclose(float(m["loss"]), j["total"], rtol=1e-4)
    np.testing.assert_allclose(float(m["grad_norm"]), j["grad_norm"], rtol=1e-4)
    clip = min(1.0, 100.0 / (float(m["grad_norm"]) + 1e-6))   # .grad holds the clipped gradient
    grads = {name: prm.grad.numpy() / clip for name, prm in model.named_parameters()}
    G = j["grad_norm"]
    for name, got in grads.items():
        want = j["grads"][name]
        err = np.linalg.norm(got - want)
        assert err <= 2e-3 * np.linalg.norm(want) + 1e-5 * G, (name, err, np.linalg.norm(want))
    # The optimizer on the port's own gradients: JAX's clipped Adam step.
    buffers = {k: v for k, v in j["sd"].items() if k.endswith("freq_bands")}
    jg = convert_state_dict({**grads, **buffers}, num_blocks=j["nb"], seq_tfmr_num_layers=2)
    want_p = state_dict_from_flax(jax.tree_util.tree_map(
        np.asarray, j["adam_step"](jg, j["params"])), num_blocks=j["nb"])
    for name, prm in model.named_parameters():
        np.testing.assert_allclose(prm.detach().numpy(), want_p[name], atol=1e-6, err_msg=name)


def _tiny():
    cfg = FlowModelConfig(ipa=IPAConfig(c_s=32, c_z=16, c_hidden=8, no_heads=2, no_qk_points=2,
                                        no_v_points=3, seq_tfmr_num_heads=2,
                                        seq_tfmr_num_layers=1, num_blocks=1),
                          node_embed_size=32, edge_embed_size=16)
    batch = device_batch(make_batch(np.random.default_rng(1), batch_size=8, pep_len=4,
                                    rec_len=8, pad_to=16), "cpu")
    return build_model(cfg, "cpu", seed=0).train(), batch


def test_train_step_reduces_loss():
    """30 Adam steps on one batch with one fixed corruption draw lower the
    objective; train and eval mode give the same loss (no dropout)."""
    model, batch = _tiny()
    noise = draw_noise(8, 16, torch.Generator().manual_seed(0), "cpu")
    with torch.no_grad():
        model.eval()
        eval_loss = sum(model.loss(batch, noise=noise).values())
        model.train()
        assert float(sum(model.loss(batch, noise=noise).values())) == float(eval_loss)
    optimizer = Optimizer(model.parameters(), {"type": "adam", "lr": 1e-3}, 100.0)
    losses = [float(train_step(model, optimizer, batch, WEIGHTS, noise=noise)["loss"])
              for _ in range(30)]
    assert np.isfinite(losses[-1]) and losses[-1] < losses[0], losses


def test_nan_rescue():
    """A poisoned batch gives a zero total and zero gradients; the optimizer
    still steps and the parameters stay finite (unmoved on a first step)."""
    model, batch = _tiny()
    bad = dict(batch)
    bad["pos_heavyatom"] = batch["pos_heavyatom"].clone()
    bad["pos_heavyatom"][0] = float("nan")
    before = [p.detach().clone() for p in model.parameters()]
    optimizer = Optimizer(model.parameters(), {"type": "adam", "lr": 1e-3}, 100.0)
    m = train_step(model, optimizer, bad, WEIGHTS, generator=torch.Generator().manual_seed(0))
    assert float(m["loss"]) == 0.0 and float(m["grad_norm"]) == 0.0
    for p, q in zip(model.parameters(), before):
        assert bool(torch.isfinite(p).all())
        assert torch.equal(p.detach(), q)


@pytest.mark.parametrize("opt_cfg", [{"type": "adam", "lr": 1e-2},
                                     {"type": "adamw", "lr": 1e-2, "weight_decay": 0.1}])
def test_accumulation_and_plateau_match_jax_optim(opt_cfg):
    """accum_grad=3 with a clip at 1.0: the parameters move only every third
    step, by the clipped Adam(W) update of the three gradients' mean, as
    optax.MultiSteps does; the plateau scheduler gives the same learning
    rates as the JAX package's on the same validation losses."""
    rng = np.random.default_rng(3)
    p0 = {"a": rng.normal(size=(5,)).astype(np.float32),
          "b": rng.normal(size=(3, 2)).astype(np.float32)}
    grads = [{k: (rng.normal(size=v.shape) * 2).astype(np.float32) for k, v in p0.items()}
             for _ in range(7)]
    tx = joptim.make_optimizer(opt_cfg, 1.0, accum_grad=3)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p0.items()}
    opt = Optimizer(tp.values(), opt_cfg, 1.0, accum_grad=3)
    for i, gr in enumerate(grads):
        updates, state = tx.update({k: jnp.asarray(v) for k, v in gr.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, t in tp.items():
            t.grad = torch.from_numpy(gr[k].copy())
        assert opt.step() == (i % 3 == 2)
        for k in p0:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), atol=1e-6)

    js, ts = joptim.PlateauScheduler(factor=0.5, patience=2, min_lr=1e-5), \
        PlateauScheduler(factor=0.5, patience=2, min_lr=1e-5)
    jlr = tlr = 1e-3
    for metric in [1.0, 0.9, 0.9, 0.95, 0.9, 0.91, 0.5, 0.6, 0.7, 0.8, 0.9] + [1.0] * 20:
        jlr, tlr = js.step(metric, jlr), ts.step(metric, tlr)
        assert jlr == tlr
    assert ts.state_dict() == js.state_dict() and tlr < 1e-3
