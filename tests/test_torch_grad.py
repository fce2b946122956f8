"""The port's backward twins and loss-side geometry against the JAX package.

The plain backward of the EdgeTransition kernel (K4) and of the distance
kernel (K5) run through their autograd Functions on the CPU, and are held
against the JAX backward kernels (``edge_transition_bwd`` and
``distance_embed_bwd`` in interpret mode) and against ``jax.grad`` of the
XLA EdgeTransition and of ``distance_embed_reference``, at B=2, L=16 as in
tests/test_pallas.py, with weights perturbed off the zero-init point as
that file does. Tolerances: fp32 rtol 1e-3 / atol 1e-4 (tests/test_pallas.py).
bf16: the same rounding points as the JAX
kernel, so each gradient within 1e-2 of its norm (a flipped bf16 rounding of
do, da2 or da1 moves one term by one bf16 step). The CUDA kernels are held
against these plain versions on the card (tests/test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pepflowww_tpu.models.ipa import EdgeTransition as JaxEdgeTransition
from pepflowww_tpu.models.pallas_dist import distance_embed_bwd, distance_embed_reference
from pepflowww_tpu.models.pallas_edge_bwd import edge_transition_bwd
from pepflowww_tpu.ops import allatom as jallatom

from pepflowww_torch.data.collate import device_batch
from pepflowww_torch.data.synthetic import make_batch
from pepflowww_torch.models import cuda_dist, cuda_edge
from pepflowww_torch.models.flow import FlowModelConfig, build_model
from pepflowww_torch.models.trunk import IPAConfig
from pepflowww_torch.ops import allatom, so3, torus

torch.set_num_threads(1)
B, L, CS, CZ = 2, 16, 128, 64
NAMES = cuda_edge.PARAM_NAMES


def T(x, grad=False):
    return torch.tensor(np.asarray(x, np.float32), requires_grad=grad)


def _edge_setup(seed=0):
    rng = np.random.default_rng(seed)
    node = jnp.asarray(rng.normal(size=(B, L, CS)).astype(np.float32))
    edge = jnp.asarray(rng.normal(size=(B, L, L, CZ)).astype(np.float32))
    mask = jnp.asarray((rng.random((B, L)) > 0.1).astype(np.float32))
    g = rng.normal(size=(B, L, L, CZ)).astype(np.float32)
    module = JaxEdgeTransition(node_embed_size=CS, edge_embed_in=CZ, edge_embed_out=CZ)
    params = module.init(jax.random.PRNGKey(0), node, edge)["params"]
    params = jax.tree_util.tree_map(
        lambda x: x + jnp.asarray(rng.normal(scale=0.05, size=x.shape).astype(np.float32)), params)
    d = lambda n: params[n]["Dense_0"]
    kp = {"k1": d("Linear_1")["kernel"], "b1": d("Linear_1")["bias"],
          "k2": d("Linear_2")["kernel"], "b2": d("Linear_2")["bias"],
          "k3": d("Linear_3")["kernel"], "b3": d("Linear_3")["bias"],
          "ln_scale": params["LayerNorm_0"]["scale"], "ln_bias": params["LayerNorm_0"]["bias"]}
    nb = node @ d("Linear_0")["kernel"] + d("Linear_0")["bias"]
    return module, params, node, edge, mask, g, kp, nb


def _port_edge_grads(edge, nb, mask, kp, g, dtype):
    ins = [T(edge, True), T(nb, True)] + [T(kp[k], True) for k in NAMES]
    if dtype == torch.bfloat16:
        ins[0], ins[1] = (torch.tensor(np.asarray(x, np.float32)).bfloat16().requires_grad_()
                          for x in (edge, nb))
    out = cuda_edge.EdgeTransitionFn.apply(ins[0], ins[1], T(mask), *ins[2:], dtype, None)
    (out.float() * torch.from_numpy(g)).sum().backward()
    return [t.grad.float().numpy() for t in ins]


def test_edge_backward_fp32_matches_jax():
    module, params, node, edge, mask, g, kp, nb = _edge_setup()
    got = _port_edge_grads(edge, nb, mask, kp, g, torch.float32)

    d_edge, d_node, d_p = edge_transition_bwd(edge, nb, mask, kp, jnp.asarray(g),
                                              dtype=jnp.float32, interpret=True)
    want = [d_edge, d_node] + [d_p[k] for k in NAMES]
    for name, a, b in zip(("edge", "node_bias") + NAMES, got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-3, atol=1e-4, err_msg=name)

    def loss_xla(edge, params):
        out = module.apply({"params": params}, node, edge, node_mask=mask)
        return jnp.sum(out * g)

    gx_edge, gx = jax.grad(loss_xla, argnums=(0, 1))(edge, params)
    np.testing.assert_allclose(got[0], np.asarray(gx_edge), rtol=1e-3, atol=1e-4)
    xla = {"k1": gx["Linear_1"]["Dense_0"]["kernel"], "b1": gx["Linear_1"]["Dense_0"]["bias"],
           "k2": gx["Linear_2"]["Dense_0"]["kernel"], "b2": gx["Linear_2"]["Dense_0"]["bias"],
           "k3": gx["Linear_3"]["Dense_0"]["kernel"], "b3": gx["Linear_3"]["Dense_0"]["bias"],
           "ln_scale": gx["LayerNorm_0"]["scale"], "ln_bias": gx["LayerNorm_0"]["bias"]}
    for name, a in zip(NAMES, got[2:]):
        np.testing.assert_allclose(a, np.asarray(xla[name]), rtol=1e-3, atol=1e-4, err_msg=name)


def test_edge_backward_bf16_matches_jax_kernel():
    _, _, _, edge, mask, g, kp, nb = _edge_setup(1)
    got = _port_edge_grads(edge, nb, mask, kp, g, torch.bfloat16)
    bf = jnp.bfloat16
    d_edge, d_node, d_p = edge_transition_bwd(edge.astype(bf), nb.astype(bf), mask, kp,
                                              jnp.asarray(g), dtype=bf, interpret=True)
    want = [d_edge, d_node] + [d_p[k] for k in NAMES]
    for name, a, b in zip(("edge", "node_bias") + NAMES, got, want):
        b = np.asarray(b, np.float32)
        assert np.linalg.norm(a - b) <= 1e-2 * np.linalg.norm(b), name


def _dist_setup(seed=11):
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(B, L, 15, 3)).astype(np.float32)
    amask = (rng.random((B, L, 15)) > 0.15).astype(np.float32)
    aa = rng.integers(0, 22, size=(B, L))
    smask = (rng.random((B, L)) > 0.2).astype(np.float32)
    p = {"table": rng.normal(size=(484, 225)) * 0.1, "k1": rng.normal(size=(225, 64)) * 0.05,
         "b1": rng.normal(size=64) * 0.1, "k2": rng.normal(size=(64, 64)) * 0.05,
         "b2": rng.normal(size=64) * 0.1}
    p = {k: np.asarray(v, np.float32) for k, v in p.items()}
    g = rng.normal(size=(B, L, L, 64)).astype(np.float32)
    return pos, amask, aa, smask, p, g


def test_distance_backward_fp32_matches_jax():
    pos, amask, aa, smask, p, g = _dist_setup()
    ins = [T(p[k], True) for k in cuda_dist.PARAM_NAMES]
    out = cuda_dist.DistanceEmbedFn.apply(T(pos), T(amask), torch.from_numpy(aa), T(smask),
                                          *ins, torch.float32, None)
    (out * torch.from_numpy(g)).sum().backward()
    got = [t.grad.numpy() for t in ins]

    aa_pair = jnp.asarray(aa[:, :, None] * 22 + aa[:, None, :], dtype=jnp.int32)
    pmask = jnp.asarray(smask[:, :, None] * smask[:, None, :])
    jp = [jnp.asarray(p[k]) for k in cuda_dist.PARAM_NAMES]
    kern = distance_embed_bwd(jnp.asarray(pos), jnp.asarray(amask), aa_pair, pmask, *jp,
                              jnp.asarray(g), dtype=jnp.float32, interpret=True)

    def lr(*params):
        out = distance_embed_reference(jnp.asarray(pos), jnp.asarray(amask), aa_pair, pmask,
                                       *params, dtype=jnp.float32)
        return jnp.sum(out * g)

    ref = jax.grad(lr, argnums=(0, 1, 2, 3, 4))(*jp)
    for name, a, b, c in zip(cuda_dist.PARAM_NAMES, got, kern, ref):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-3, atol=1e-4, err_msg=name)
        np.testing.assert_allclose(a, np.asarray(c), rtol=1e-3, atol=1e-4, err_msg=name)


def test_bare_kernel_wrappers_refuse_autograd_and_model_grads_fill():
    """The forward wrappers have no autograd and say so; the modules route
    through the Functions, so a CPU model with ``use_pallas`` gives every
    parameter, EdgeTransition and distance block included, a finite .grad."""
    _, _, _, edge, mask, _, kp, nb = _edge_setup(2)
    p = {k: T(kp[k], True) for k in NAMES}
    with pytest.raises(RuntimeError, match="no autograd"):
        cuda_edge.fused_edge_transition(T(edge), T(nb), T(mask), p, torch.float32)
    with torch.no_grad():
        cuda_edge.fused_edge_transition(T(edge), T(nb), T(mask), p, torch.float32)
    pos, amask, aa, smask, pd, _ = _dist_setup()
    with pytest.raises(RuntimeError, match="no autograd"):
        cuda_dist.fused_distance_embed(T(pos), T(amask), torch.from_numpy(aa), T(smask),
                                       {k: T(v, True) for k, v in pd.items()}, torch.float32)

    cfg = FlowModelConfig(ipa=IPAConfig(num_blocks=2, dtype="bfloat16", use_pallas=True))
    model = build_model(cfg, "cpu", seed=3).train()
    with torch.no_grad():
        for prm in model.parameters():
            prm.add_(0.02 * torch.randn(prm.shape, generator=torch.Generator().manual_seed(4)))
    batch = device_batch(make_batch(np.random.default_rng(5), batch_size=2, pep_len=4,
                                    rec_len=8, pad_to=16), "cpu")
    losses = model.loss(batch, torch.Generator().manual_seed(6))
    sum(losses.values()).backward()
    for name, prm in model.named_parameters():
        assert prm.grad is not None and bool(torch.isfinite(prm.grad).all()), name
    for name in ("edge_transition_0.trunk.0.weight", "edge_transition_0.initial_embed.weight",
                 "aapair_to_distcoef.weight", "distance_embed.0.weight"):
        grads = [prm.grad for n, prm in model.named_parameters() if n.endswith(name)]
        assert grads and float(grads[0].abs().sum()) > 0, name


def test_bb3_atoms_golden_and_jax(golden):
    g = golden("bb3")
    got = allatom.bb3_atoms(T(g["trans"]), T(g["rots"])).numpy()
    np.testing.assert_allclose(got, g["bb3"], atol=1e-5)
    want = jallatom.bb3_atoms(jnp.asarray(g["trans"]), jnp.asarray(g["rots"]))
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)


def test_loss_geometry_gradients_finite_at_degenerate_angles():
    """calc_rot_vf / rotmat_to_rotvec at θ = 0, 1e-9, π - 1e-5, π and a
    generic angle, torus.logmap at a difference of 0 and π, and the
    torsion-masked loss: values and gradients stay finite under autograd."""
    axis = torch.tensor([0.3, -0.5, 0.8])
    axis = axis / axis.norm()
    thetas = torch.tensor([0.0, 1e-9, 1.0, np.pi - 1e-5, np.pi])
    R = so3.rotvec_to_rotmat(thetas[:, None] * axis).clone().requires_grad_()
    base = so3.rotvec_to_rotmat(torch.tensor([0.1, 0.2, -0.3])).expand(5, 3, 3)
    vf = so3.calc_rot_vf(base @ R.detach(), base @ R)
    rv = so3.rotmat_to_rotvec(R)
    (vf.square().sum() + rv.square().sum()).backward()
    assert bool(torch.isfinite(vf).all()) and bool(torch.isfinite(rv).all())
    assert bool(torch.isfinite(R.grad).all())
    np.testing.assert_allclose(rv.detach().norm(dim=-1).numpy()[:4], thetas.numpy()[:4], atol=2e-3)

    x = torch.tensor([0.5, 1.0, 2.0, 3.0], requires_grad=True)
    y = torch.tensor([0.5, 1.0 + np.pi, 2.0 + 1e-7, 3.0 - np.pi], requires_grad=True)
    d = torus.logmap(x, y)
    aa = torch.tensor([0, 5, 20, 21])
    mask = allatom.torsions_mask_for(aa)[:, 0]
    (torch.cat([torch.sin(d), torch.cos(d)]).square().sum() + (d * mask).square().sum()).backward()
    assert bool(torch.isfinite(x.grad).all()) and bool(torch.isfinite(y.grad).all())
