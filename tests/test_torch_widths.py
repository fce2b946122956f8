"""The production profile's kernels at the JAX package's 2x and 4x widths
(c_z = F = 128, 256; hidden 3 c_z; readout lanes 8 + c_z/4), on the CPU.

- ``cuda_edge.edge_transition_plain`` (readout off and on) and the
  gradients of ``EdgeTransitionFn`` (whose backward on the CPU is
  ``edge_transition_bwd_plain``) against the JAX kernels
  ``fused_edge_transition`` and ``edge_transition_bwd`` (Pallas, interpret
  mode) in float32, at c_z = 128 and 256: 2e-4, tests/test_torch_edge.py's
  bound, absolute on the outputs and on the gradients beside 1e-3 of each
  entry (sums over B L^2 = 512 pairs in another order).
- ``cuda_dist.distance_embed_plain`` and ``DistanceEmbedFn``'s gradients at
  F = 128 against ``fused_distance_embed`` and ``distance_embed_bwd``
  (interpret mode), the same bounds.
- The port's 2x FlowModel (2 blocks, the production profile's kernel flags,
  float32 on the CPU so the kernels take their plain versions) with weights
  from ``convert.state_dict_from_flax`` of a JAX FlowModel built at 2x:
  encode, one denoise pass, and one training step's losses and gradients
  against JAX's (its XLA branch) with the JAX step's own draws injected, at
  tests/test_torch_model.py's and tests/test_torch_train.py's tolerances.
- The width checks: c_z = 96, a hidden width other than 3 c_z, more readout
  lanes than 8 + c_z/4, F = 96, and the int8 kernel above c_z = 64 raise.

The wide kernels' own schedule is emulated in tests/test_torch_widths_tiles.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pepflowww_tpu.models.flow import FlowModel as JaxFlowModel
from pepflowww_tpu.models.flow import FlowModelConfig as JaxFlowModelConfig
from pepflowww_tpu.models.pallas_dist import distance_embed_bwd as jax_dist_bwd
from pepflowww_tpu.models.pallas_dist import fused_distance_embed as jax_dist
from pepflowww_tpu.models.pallas_edge import fused_edge_transition as jax_edge
from pepflowww_tpu.models.pallas_edge_bwd import edge_transition_bwd as jax_edge_bwd
from pepflowww_tpu.models.trunk import IPAConfig as JaxIPAConfig
from pepflowww_tpu.ops import so3 as jso3
from pepflowww_tpu.ops import torus as jtorus
from pepflowww_tpu.training.train_step import make_loss_fn

from pepflowww_torch.bench import width_config
from pepflowww_torch.convert import state_dict_from_flax
from pepflowww_torch.data.collate import device_batch
from pepflowww_torch.data.synthetic import make_batch
from pepflowww_torch.models import cuda_dist, cuda_edge
from pepflowww_torch.models.flow import build_model
from pepflowww_torch.training.train_step import loss_and_total

torch.set_num_threads(1)
B, L, H, A, NAA = 2, 16, 8, 15, 22
T = torch.from_numpy
WEIGHTS = {"trans_loss": 0.5, "rot_loss": 0.5, "bb_atom_loss": 0.25,
           "seqs_loss": 1.0, "angle_loss": 1.0, "torsion_loss": 0.5}


def _edge_inputs(cz, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (rng.normal(size=s) * sc).astype(np.float32)
    hid = 3 * cz
    p = {"k1": f(hid, hid, sc=0.05), "b1": f(hid, sc=0.1), "k2": f(hid, hid, sc=0.05),
         "b2": f(hid, sc=0.1), "k3": f(hid, cz, sc=0.05), "b3": f(cz, sc=0.1),
         "ln_scale": 1 + f(cz, sc=0.1), "ln_bias": f(cz, sc=0.1)}
    readout = (f(cz, H, sc=0.1), f(H), f(cz, cz // 4, sc=0.1), f(cz // 4))
    mask = (rng.random((B, L)) > 0.1).astype(np.float32)
    return f(B, L, L, cz), f(B, L, cz), mask, p, readout, f(B, L, L, cz)


@pytest.mark.parametrize("cz", [128, 256])
def test_edge_plain_and_grads_match_jax_kernels(cz):
    edge, nb, mask, p, ro, g = _edge_inputs(cz, cz)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jargs = (jnp.asarray(edge), jnp.asarray(nb), jnp.asarray(mask), jp)
    pt = {k: T(v) for k, v in p.items()}
    targs = (T(edge), T(nb), T(mask), pt, torch.float32)
    want = jax_edge(*jargs, dtype=jnp.float32, interpret=True)
    np.testing.assert_allclose(cuda_edge.edge_transition_plain(*targs).numpy(), np.asarray(want),
                               atol=2e-4)
    want = jax_edge(*jargs, dtype=jnp.float32, interpret=True,
                    readout=tuple(jnp.asarray(x) for x in ro))
    got = cuda_edge.edge_transition_plain(*targs, readout=tuple(T(x) for x in ro))
    for name, a, b in zip(("out", "b", "pz"), got, want):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-4, err_msg=name)

    ins = [T(edge).requires_grad_(), T(nb).requires_grad_()] + \
        [T(p[k]).requires_grad_() for k in cuda_edge.PARAM_NAMES]
    out = cuda_edge.EdgeTransitionFn.apply(ins[0], ins[1], T(mask), *ins[2:], torch.float32, None)
    (out * T(g)).sum().backward()
    d_edge, d_node, d_p = jax_edge_bwd(*jargs, jnp.asarray(g), dtype=jnp.float32, interpret=True)
    want = [d_edge, d_node] + [d_p[k] for k in cuda_edge.PARAM_NAMES]
    for name, t, b in zip(("edge", "node_bias") + cuda_edge.PARAM_NAMES, ins, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(b), rtol=1e-3, atol=2e-4,
                                   err_msg=name)


def test_dist_plain_and_grads_match_jax_kernels():
    F = 128
    rng = np.random.default_rng(128)
    pos = rng.normal(size=(B, L, A, 3)).astype(np.float32)
    amask = (rng.random((B, L, A)) > 0.15).astype(np.float32)
    aa = rng.integers(0, NAA, size=(B, L))
    smask = (rng.random((B, L)) > 0.2).astype(np.float32)
    p = {"table": rng.normal(size=(NAA * NAA, A * A)).astype(np.float32) * 0.1,
         "k1": rng.normal(size=(A * A, F)).astype(np.float32) * 0.05,
         "b1": rng.normal(size=(F,)).astype(np.float32) * 0.1,
         "k2": rng.normal(size=(F, F)).astype(np.float32) * 0.05,
         "b2": rng.normal(size=(F,)).astype(np.float32) * 0.1}
    g = rng.normal(size=(B, L, L, F)).astype(np.float32)
    names = cuda_dist.PARAM_NAMES
    jargs = (jnp.asarray(pos), jnp.asarray(amask),
             jnp.asarray(aa[:, :, None] * NAA + aa[:, None, :], dtype=jnp.int32),
             jnp.asarray(smask[:, :, None] * smask[:, None, :]),
             *(jnp.asarray(p[k]) for k in names))
    want = jax_dist(*jargs, dtype=jnp.float32, interpret=True)
    data = (T(pos), T(amask), T(aa), T(smask))
    prm = [T(p[k]).requires_grad_() for k in names]
    out = cuda_dist.DistanceEmbedFn.apply(*data, *prm, torch.float32, None)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), atol=2e-4)
    (out * T(g)).sum().backward()
    want = jax_dist_bwd(*jargs, jnp.asarray(g), dtype=jnp.float32, interpret=True)
    for name, t, b in zip(names, prm, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(b), rtol=1e-3, atol=2e-4,
                                   err_msg=name)


def _jax_config(width, nb):
    return JaxFlowModelConfig(
        node_embed_size=128 * width, edge_embed_size=64 * width,
        ipa=JaxIPAConfig(c_s=128 * width, c_z=64 * width, c_hidden=128 * width, no_heads=8,
                         no_qk_points=8, no_v_points=12, seq_tfmr_num_heads=8,
                         seq_tfmr_num_layers=2, num_blocks=nb))


def _jax_noise(jmodel, params, key, B, L):
    """The JAX loss's draws under the ``corruption`` stream `key`, in its
    order (tests/test_torch_train.py's construction)."""
    key = jmodel.apply({"params": params}, method=lambda m: m.make_rng("corruption"),
                       rngs={"corruption": key})
    k_t, k_trans, k_rot, k_ang, k_seq, k_seqsamp, k_predsamp = jax.random.split(key, 7)
    return {"t": jax.random.uniform(k_t, (B, 1)),
            "trans_0": jax.random.normal(k_trans, (B, L, 3)),
            "rotmats_0": jso3.uniform_so3(k_rot, (B, L)),
            "angles_0": jtorus.random_uniform(k_ang, (B, L, 5)),
            "seqs_0": jax.random.normal(k_seq, (B, L, 20)),
            "gumbel_seqs_t": jax.random.gumbel(k_seqsamp, (B, L, 20)),
            "gumbel_pred": jax.random.gumbel(k_predsamp, (B, L, 20))}


def _jax_params(jmodel, jb, seed):
    """The JAX model's init, with seeded N(0, 0.02^2) noise on every leaf
    (its final layers are zero at init)."""
    key = jax.random.PRNGKey(0)
    params = jax.jit(jmodel.init)({"params": key, "corruption": key}, jb)["params"]
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: x + jnp.asarray(0.02 * rng.normal(size=x.shape), x.dtype), params)


def test_flow_model_2x_matches_jax():
    """encode, one denoise pass and one training step of the 2x model, 2
    blocks, against the JAX model with the same weights: encode 2e-4, the
    denoise 5e-3 (angles on the circle), the losses rtol 1e-4 and each
    gradient within 2e-3 of its norm plus 1e-5 of the global norm. The
    encoded edge features are compared off the diagonal: a pair (i, i)'s
    inter-residue dihedrals are angles between vectors of rounding size in
    both packages (at 1x as at 2x), which differ there by up to ~2e-3 with
    these weights; the denoise pass takes JAX's encoding in both."""
    nb, width = 2, 2
    bnp = make_batch(np.random.default_rng(3), batch_size=B, pep_len=5, rec_len=11, pad_to=L)
    jb = {k: jnp.asarray(v) for k, v in bnp.items()
          if isinstance(v, np.ndarray) and v.dtype.kind in "biuf"}
    jmodel = JaxFlowModel(_jax_config(width, nb))
    params = _jax_params(jmodel, jb, 4)
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

    sd = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params), num_blocks=nb)
    cfg = width_config(width, nb)
    cfg = dataclasses.replace(cfg, ipa=dataclasses.replace(cfg.ipa, dtype=None))  # float32
    assert cfg.ipa.use_pallas and cfg.ipa.c_z == 128
    model = build_model(cfg, "cpu", state_dict=sd)
    batch = device_batch(bnp, "cpu")
    with torch.no_grad():
        got = model.encode(batch)
        for i, (a, b) in enumerate(zip(got, enc)):
            if a.is_floating_point():
                a, b = a.numpy(), np.asarray(b)
                if i == 5:   # edge features: off the diagonal (see the docstring)
                    off = ~np.eye(L, dtype=bool)
                    a, b = a[:, off], b[:, off]
                np.testing.assert_allclose(a, b, atol=2e-4, err_msg=str(i))
        args = [T(t)] + [T(np.array(x)) for x in enc]
        td = model.denoise(*args, batch["generate_mask"], batch["res_mask"],
                           fused_pair_readout=True)
    for name, a, b in zip(("rot", "trans", "angles", "logits"), td, den):
        d = a.numpy() - np.asarray(b)
        if name == "angles":
            d = np.arctan2(np.sin(d), np.cos(d))
        np.testing.assert_allclose(d, 0.0, atol=5e-3, err_msg=name)

    model.train()
    total_t, losses_t = loss_and_total(model, batch, WEIGHTS,
                                       noise={k: T(np.array(v)) for k, v in noise.items()})
    total_t.backward()
    for name, v in losses.items():
        np.testing.assert_allclose(float(losses_t[name].detach()), float(v), rtol=1e-4,
                                   err_msg=name)
    np.testing.assert_allclose(float(total_t.detach()), float(total), rtol=1e-4)
    want_g = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, grads), num_blocks=nb)
    G = float(np.sqrt(sum(np.sum(np.square(want_g[n])) for n, _ in model.named_parameters())))
    for name, prm in model.named_parameters():
        err = np.linalg.norm(prm.grad.numpy() - want_g[name])
        assert err <= 2e-3 * np.linalg.norm(want_g[name]) + 1e-5 * G, name


def test_unsupported_widths_raise():
    """kernel_operands, which every kernel call on the card goes through,
    and the width checks reject what the kernels do not take."""
    def edge_params(cz, hid):
        z = lambda *s: torch.zeros(*s)
        return {"k1": z(3 * cz, hid), "b1": z(hid), "k2": z(hid, hid), "b2": z(hid),
                "k3": z(hid, cz), "b3": z(cz), "ln_scale": z(cz), "ln_bias": z(cz)}

    with pytest.raises(ValueError, match="c_z = 96"):
        cuda_edge.kernel_operands(edge_params(96, 288))
    with pytest.raises(ValueError, match="hidden"):
        cuda_edge.kernel_operands(edge_params(128, 256))
    ro = lambda n_pz: (torch.zeros(128, 8), torch.zeros(8), torch.zeros(128, n_pz),
                       torch.zeros(n_pz))
    assert cuda_edge.kernel_operands(edge_params(128, 384), ro(32))["wrt"].shape == (64, 128)
    with pytest.raises(ValueError, match="readout lanes"):
        cuda_edge.kernel_operands(edge_params(128, 384), ro(33))
    with pytest.raises(ValueError, match="int8"):
        cuda_edge.kernel_operands(edge_params(128, 384), quant_int8=True)
    for cz, hid in ((96, 288), (128, 256)):
        with pytest.raises(ValueError):
            cuda_edge.check_widths(cz, cz, hid)
    dp = lambda f: {"table": torch.zeros(484, 225), "k1": torch.zeros(225, f),
                    "b1": torch.zeros(f), "k2": torch.zeros(f, f), "b2": torch.zeros(f)}
    with pytest.raises(ValueError, match="F = 96"):
        cuda_dist.kernel_operands(dp(96))
    ops = cuda_dist.kernel_operands(dp(128))
    assert ops["k1t"].shape == (128, 256) and ops["k1p"].shape == (256, 128)
