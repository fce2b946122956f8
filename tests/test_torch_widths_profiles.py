"""The port's 2x FlowModel (2 blocks, float32 on the CPU, so the kernels
take their plain versions) in the fused-IPA and int8 serving profiles,
with weights from ``convert.state_dict_from_flax`` of a JAX FlowModel built
at 2x (tests/test_torch_widths.py's construction).

- The fused-IPA profile (``use_pallas_ipa``) against the JAX model with
  ``use_pallas_ipa=True`` (its fused IPA interior ``fused_ipa2_vjp``, Pallas
  in interpret mode, forward and hand-written backward): encode, one
  denoise pass and one training step's losses and gradients, with the JAX
  step's own draws injected, at tests/test_torch_widths.py's tolerances
  (encode 2e-4 off the diagonal of the edge features; the denoise 5e-3;
  the losses rtol 1e-4; each gradient within 2e-3 of its norm plus 1e-5 of
  the global norm).
- The int8 serving profile (``quant_int8``) against the JAX model with
  ``use_pallas=True, quant_int8=True`` (the int8 EdgeTransition kernel in
  interpret mode): one denoise pass with the pair readouts, at the denoise
  tolerance 5e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pepflowww_tpu.models.flow import FlowModel as JaxFlowModel
from pepflowww_tpu.training.train_step import make_loss_fn

from pepflowww_torch.bench import width_config
from pepflowww_torch.convert import state_dict_from_flax
from pepflowww_torch.data.collate import device_batch
from pepflowww_torch.data.synthetic import make_batch
from pepflowww_torch.models.flow import build_model
from pepflowww_torch.models.ipa import EdgeTransition, InvariantPointAttention
from pepflowww_torch.training.train_step import loss_and_total

from test_torch_widths import WEIGHTS, B, L, _jax_config, _jax_noise, _jax_params

torch.set_num_threads(1)
T = torch.from_numpy
NB, WIDTH = 2, 2


def _setup(seed, **jax_flags):
    """(numpy batch, JAX batch, the JAX model with `jax_flags` set in its
    IPA config, its noised params, the port's float32 model of the same
    weights with the matching profile)."""
    bnp = make_batch(np.random.default_rng(seed), batch_size=B, pep_len=5, rec_len=11, pad_to=L)
    jb = {k: jnp.asarray(v) for k, v in bnp.items()
          if isinstance(v, np.ndarray) and v.dtype.kind in "biuf"}
    cfg = _jax_config(WIDTH, NB)
    params = _jax_params(JaxFlowModel(cfg), jb, seed + 1)
    jmodel = JaxFlowModel(dataclasses.replace(cfg, ipa=dataclasses.replace(cfg.ipa, **jax_flags)))
    sd = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params), num_blocks=NB)
    port = width_config(WIDTH, NB, use_pallas_ipa=jax_flags.get("use_pallas_ipa", False),
                        quant_int8=jax_flags.get("quant_int8", False))
    port = dataclasses.replace(port, ipa=dataclasses.replace(port.ipa, dtype=None))  # float32
    return bnp, jb, jmodel, params, build_model(port, "cpu", state_dict=sd)


def _check_denoise(got, want):
    for name, a, b in zip(("rot", "trans", "angles", "logits"), got, want):
        d = a.numpy() - np.asarray(b)
        if name == "angles":
            d = np.arctan2(np.sin(d), np.cos(d))
        np.testing.assert_allclose(d, 0.0, atol=5e-3, err_msg=name)


def test_flow_model_2x_fused_ipa_matches_jax():
    bnp, jb, jmodel, params, model = _setup(13, use_pallas_ipa=True)
    ipas = [m for m in model.modules() if isinstance(m, InvariantPointAttention)]
    assert len(ipas) == NB and all(m.use_kernels for m in ipas)
    t = np.full((B, 1), 0.4, np.float32)
    key = jax.random.PRNGKey(7)

    @jax.jit
    def run(params, jb, t, key):
        enc = jmodel.apply({"params": params}, jb, method="encode")
        den = jmodel.apply({"params": params}, t, *enc, jb["generate_mask"], jb["res_mask"],
                           method="denoise", fused_pair_readout=True)
        loss = jax.value_and_grad(make_loss_fn(jmodel, WEIGHTS), has_aux=True)(params, jb, key)
        return enc, den, loss, _jax_noise(jmodel, params, key, B, L)

    enc, den, ((total, losses), grads), noise = run(params, jb, jnp.asarray(t), key)
    batch = device_batch(bnp, "cpu")
    with torch.no_grad():
        got = model.encode(batch)
        for i, (a, b) in enumerate(zip(got, enc)):
            if a.is_floating_point():
                a, b = a.numpy(), np.asarray(b)
                if i == 5:   # edge features off the diagonal (tests/test_torch_widths.py)
                    off = ~np.eye(L, dtype=bool)
                    a, b = a[:, off], b[:, off]
                np.testing.assert_allclose(a, b, atol=2e-4, err_msg=str(i))
        td = model.denoise(T(t), *[T(np.array(x)) for x in enc], batch["generate_mask"],
                           batch["res_mask"], fused_pair_readout=True)
    _check_denoise(td, den)

    model.train()
    total_t, losses_t = loss_and_total(model, batch, WEIGHTS,
                                       noise={k: T(np.array(v)) for k, v in noise.items()})
    total_t.backward()
    for name, v in losses.items():
        np.testing.assert_allclose(float(losses_t[name].detach()), float(v), rtol=1e-4,
                                   err_msg=name)
    np.testing.assert_allclose(float(total_t.detach()), float(total), rtol=1e-4)
    want_g = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, grads), num_blocks=NB)
    G = float(np.sqrt(sum(np.sum(np.square(want_g[n])) for n, _ in model.named_parameters())))
    for name, prm in model.named_parameters():
        err = np.linalg.norm(prm.grad.numpy() - want_g[name])
        assert err <= 2e-3 * np.linalg.norm(want_g[name]) + 1e-5 * G, name


def test_denoise_2x_int8_matches_jax():
    bnp, jb, jmodel, params, model = _setup(17, use_pallas=True, quant_int8=True)
    ets = [m for m in model.modules() if isinstance(m, EdgeTransition)]
    assert len(ets) == NB - 1 and all(m.quant_int8 and m.use_kernels for m in ets)
    t = np.full((B, 1), 0.6, np.float32)

    @jax.jit
    def run(params, jb, t):
        enc = JaxFlowModel(_jax_config(WIDTH, NB)).apply({"params": params}, jb, method="encode")
        den = jmodel.apply({"params": params}, t, *enc, jb["generate_mask"], jb["res_mask"],
                           method="denoise", fused_pair_readout=True)
        return enc, den

    enc, den = run(params, jb, jnp.asarray(t))
    batch = device_batch(bnp, "cpu")
    with torch.no_grad():
        td = model.denoise(T(t), *[T(np.array(x)) for x in enc], batch["generate_mask"],
                           batch["res_mask"], fused_pair_readout=True)
    _check_denoise(td, den)
