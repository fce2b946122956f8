"""The port's EdgeTransition (kernel B's module) against the JAX package.

The plain version of the CUDA kernel (``cuda_edge.edge_transition_plain``)
runs in float32 against the JAX Pallas kernel ``fused_edge_transition``
(interpret mode) and the JAX module's XLA branch at 2e-4, as
tests/test_pallas.py holds those two; its readout outputs against GEMMs over
its own output at 2e-5 (test_fused_readout_matches_xla). In bf16 it is held
to the JAX kernel's bf16 run within one bf16 step of the output (3e-2).
The CUDA kernels' own arithmetic and operands are held in
tests/test_torch_edge_operands.py; the CUDA kernel itself is held against
the plain version on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pepflowww_tpu.models.ipa import EdgeTransition as JaxEdgeTransition
from pepflowww_tpu.models.pallas_edge import fused_edge_transition as jax_fused

from pepflowww_torch.models import cuda_edge
from pepflowww_torch.models.ipa import EdgeTransition

torch.set_num_threads(1)
B, L, CS, CZ, H, DZ = 2, 32, 128, 64, 8, 16


def _inputs(seed=0, B=B, L=L):
    rng = np.random.default_rng(seed)
    node = rng.normal(size=(B, L, CS)).astype(np.float32)
    edge = rng.normal(size=(B, L, L, CZ)).astype(np.float32)
    mask = (rng.random((B, L)) > 0.1).astype(np.float32)

    def dense(i, o, s):
        return {"kernel": (rng.normal(size=(i, o)) * s).astype(np.float32),
                "bias": (rng.normal(size=(o,)) * 0.1).astype(np.float32)}

    params = {"Linear_0": {"Dense_0": dense(CS, CZ, 0.1)},
              "Linear_1": {"Dense_0": dense(192, 192, 0.1)},
              "Linear_2": {"Dense_0": dense(192, 192, 0.1)},
              "Linear_3": {"Dense_0": dense(192, CZ, 0.1)},
              "LayerNorm_0": {"scale": (1 + 0.1 * rng.normal(size=CZ)).astype(np.float32),
                              "bias": (0.1 * rng.normal(size=CZ)).astype(np.float32)}}
    readout = tuple(x.astype(np.float32) for x in (
        rng.normal(size=(CZ, H)) * 0.1, rng.normal(size=H),
        rng.normal(size=(CZ, DZ)) * 0.1, rng.normal(size=DZ)))
    return node, edge, mask, params, readout


def _port_module(params, dtype=None, use_kernels=False):
    m = EdgeTransition(CS, CZ, CZ, dtype=dtype, use_kernels=use_kernels)
    names = {"Linear_0": "initial_embed", "Linear_1": "trunk.0", "Linear_2": "trunk.2",
             "Linear_3": "final_layer"}
    sd = {}
    for k, v in names.items():
        sd[f"{v}.weight"] = torch.from_numpy(params[k]["Dense_0"]["kernel"].T.copy())
        sd[f"{v}.bias"] = torch.from_numpy(params[k]["Dense_0"]["bias"])
    sd["layer_norm.weight"] = torch.from_numpy(params["LayerNorm_0"]["scale"])
    sd["layer_norm.bias"] = torch.from_numpy(params["LayerNorm_0"]["bias"])
    m.load_state_dict(sd, strict=True)
    return m


def _jax_kernel_params(params):
    d = lambda n: params[n]["Dense_0"]
    return {"k1": d("Linear_1")["kernel"], "b1": d("Linear_1")["bias"],
            "k2": d("Linear_2")["kernel"], "b2": d("Linear_2")["bias"],
            "k3": d("Linear_3")["kernel"], "b3": d("Linear_3")["bias"],
            "ln_scale": params["LayerNorm_0"]["scale"], "ln_bias": params["LayerNorm_0"]["bias"]}


def _port_kernel_params(params):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in _jax_kernel_params(params).items()}


def _node_bias(params, node):
    d = params["Linear_0"]["Dense_0"]
    return node @ d["kernel"] + d["bias"]


@pytest.mark.parametrize("use_kernels", [False, True])
def test_module_matches_jax_xla_fp32(use_kernels):
    node, edge, mask, params, _ = _inputs()
    want = JaxEdgeTransition(node_embed_size=CS, edge_embed_in=CZ, edge_embed_out=CZ).apply(
        {"params": params}, jnp.asarray(node), jnp.asarray(edge), node_mask=jnp.asarray(mask))
    m = _port_module(params, use_kernels=use_kernels)
    with torch.no_grad():
        got = m(torch.from_numpy(node), torch.from_numpy(edge), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


def test_plain_matches_jax_pallas_fp32():
    node, edge, mask, params, _ = _inputs(1)
    nb = _node_bias(params, node)
    want = jax_fused(jnp.asarray(edge), jnp.asarray(nb), jnp.asarray(mask),
                     _jax_kernel_params(params), dtype=jnp.float32, interpret=True)
    got = cuda_edge.fused_edge_transition(torch.from_numpy(edge), torch.from_numpy(nb),
                                          torch.from_numpy(mask), _port_kernel_params(params),
                                          dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


def test_readout_matches_gemms_over_output():
    """test_fused_readout_matches_xla's construction: the transposed
    readouts equal linear_b / down_z GEMMs over the emitted output."""
    node, edge, mask, params, readout = _inputs(3)
    nb = torch.from_numpy(_node_bias(params, node))
    p = _port_kernel_params(params)
    ro = tuple(torch.from_numpy(x) for x in readout)
    args = (torch.from_numpy(edge), nb, torch.from_numpy(mask), p)
    out0 = cuda_edge.fused_edge_transition(*args, dtype=torch.float32)
    out1, bt, pzt = cuda_edge.fused_edge_transition(*args, dtype=torch.float32, readout=ro)
    np.testing.assert_array_equal(out0.numpy(), out1.numpy())
    kb, bb, kdz, bdz = readout
    o = out0.numpy()
    np.testing.assert_allclose(bt.numpy(), np.transpose(o @ kb + bb, (0, 3, 1, 2)), atol=2e-5)
    np.testing.assert_allclose(pzt.numpy(), np.transpose(o @ kdz + bdz, (0, 3, 1, 2)), atol=2e-5)

    _, jbt, jpzt = jax_fused(jnp.asarray(edge), jnp.asarray(nb.numpy()), jnp.asarray(mask),
                             _jax_kernel_params(params), dtype=jnp.float32, interpret=True,
                             readout=tuple(jnp.asarray(x) for x in readout))
    np.testing.assert_allclose(bt.numpy(), np.asarray(jbt), atol=2e-4)
    np.testing.assert_allclose(pzt.numpy(), np.asarray(jpzt), atol=2e-4)


def test_plain_bf16_matches_jax_pallas_bf16():
    """Same rounding points as the JAX kernel in bf16: agreement within one
    bf16 step of the O(1) outputs (3e-2); fp32 sums in another order may
    flip a rounding."""
    node, edge, mask, params, readout = _inputs(4)
    nb = _node_bias(params, node)
    bf = jnp.bfloat16
    want, wb, wpz = jax_fused(jnp.asarray(edge).astype(bf), jnp.asarray(nb).astype(bf),
                              jnp.asarray(mask), _jax_kernel_params(params), dtype=bf,
                              interpret=True, readout=tuple(jnp.asarray(x) for x in readout))
    got, gb, gpz = cuda_edge.fused_edge_transition(
        torch.from_numpy(edge).bfloat16(), torch.from_numpy(nb).bfloat16(),
        torch.from_numpy(mask), _port_kernel_params(params), dtype=torch.bfloat16,
        readout=tuple(torch.from_numpy(x) for x in readout))
    for a, b in ((got, want), (gb, wb), (gpz, wpz)):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b.astype(jnp.float32)), atol=3e-2)


def test_cuda_tensor_without_card_raises():
    """A CUDA tensor never falls back to the plain version: it goes to the
    kernel or raises (here, where no CUDA tensor can be made, the wrapper's
    checks reject a non-CPU device before any launch)."""
    node, edge, mask, params, _ = _inputs(5, B=1, L=8)
    e = torch.from_numpy(edge).bfloat16().to("meta")
    with pytest.raises(ValueError):
        cuda_edge.fused_edge_transition(e, torch.zeros(1, 8, CZ, dtype=torch.bfloat16,
                                                       device="meta"),
                                        torch.ones(1, 8, device="meta"),
                                        _port_kernel_params(params))

