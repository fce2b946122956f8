"""The fused-IPA and int8 profiles' kernels at the JAX package's 2x and 8x
widths, on the CPU, where their wrappers take the plain versions.

- ``cuda_ipa.ipa2_plain`` and ``ipa2_bwd_plain`` against the JAX kernels
  ``fused_ipa2`` and ``fused_ipa2_bwd`` (Pallas, interpret mode, through
  ``jax.vjp`` of ``fused_ipa2_vjp``) at (C, CZ4) = (256, 32) and (1024,
  128), H 8, Pq 8, Pv 12, B 1, L 16, fp32: the outputs within 2e-4, each
  gradient within 2e-4 of its largest entry (sums over 16 keys and up to
  1024 channels in another order; tests/test_torch_ipa2.py's inputs at
  these widths). ``IPA2Fn``'s gradients (forward and backward through the
  plain versions on the CPU) against JAX's vjp at tests/test_torch_ipa2.py's
  bound, 1e-3 of each gradient's largest entry; no gradient for the key
  mask, the point-weight gradient summed over the batch.
- ``cuda_edge.edge_transition_int8_plain`` (readout on) against
  ``fused_edge_transition(quant_int8=True)`` (interpret mode, fp32) at c_z
  = 128 and 512 (hidden 384, 1536), B 1, L 16. Every pair row within 1e-5
  (fp32: the same arithmetic, sums in another order), except rows whose
  float64 hidden layer h1 or h2 has an entry within 1e-4 of an int8 level
  from a half-level tie: there the two fp32 sums may round that entry to
  the two neighbouring levels (at c_z 128 with these inputs, row (0, 12,
  10), whose h1 entry 116 lies 1.2e-5 levels above 95.5: the port rounds
  it to 95, the JAX kernel to 96), which moves the row by up to a few
  1e-3 after LayerNorm. Such rows are at most 2% of the rows, and their
  outputs still within 5e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pepflowww_tpu.models import pallas_ipa2 as P
from pepflowww_tpu.models.pallas_edge import fused_edge_transition as jax_edge

from pepflowww_torch.models import cuda_edge, cuda_ipa

from test_torch_ipa2 import NAMES, _inputs, _t

torch.set_num_threads(1)
T = torch.from_numpy


@pytest.mark.parametrize("C,CZ4", [(256, 32), (1024, 128)], ids=["2x", "8x"])
def test_ipa_plain_and_autograd_match_jax_kernels(C, CZ4):
    args = _inputs(B=1, L=16, H=8, C=C, Pq=8, Pv=12, CZ4=CZ4, seed=C)
    rng = np.random.default_rng(C + 1)
    shapes = ((1, 16, 8 * C), (1, 16, 3 * 8 * 12), (1, 16, 8 * 12), (1, 16, 8 * CZ4))
    cots = [rng.normal(size=s).astype(np.float32) for s in shapes]

    @jax.jit
    def run(a, c):
        out, vjp = jax.vjp(lambda *x: P.fused_ipa2_vjp(*x, 1e-8, True), *a)
        return out, vjp(tuple(c))

    out, grads = run([jnp.asarray(a) for a in args], [jnp.asarray(c) for c in cots])
    got = cuda_ipa.ipa2_plain(*[_t(a) for a in args])
    for name, a, b in zip(("o", "optl", "norm", "opair"), got, out):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-4, err_msg=name)
    # fused_ipa2_vjp's gradients are fused_ipa2_bwd's outputs, the point
    # weight's summed over the batch (of one) and none for the key mask.
    plain = cuda_ipa.ipa2_bwd_plain(*[_t(a) for a in args], *[_t(c) for c in cots])
    want = [np.asarray(g) for g in grads]
    for name, a, b in zip(NAMES[:8] + ("sw",), plain, want[:8] + [want[9]]):
        scale = float(np.abs(b).max()) + 1e-8
        np.testing.assert_allclose(a.numpy().reshape(b.shape) / scale, b / scale, atol=2e-4,
                                   err_msg=name)

    ins = [_t(a, grad=n != "maskb") for n, a in zip(NAMES, args)]
    out = cuda_ipa.IPA2Fn.apply(*ins, 1e-8)
    sum((o * T(c)).sum() for o, c in zip(out, cots)).backward()
    assert ins[8].grad is None
    for name, x, b in zip(NAMES, ins, want):
        if name == "maskb":
            continue
        scale = float(np.abs(b).max()) + 1e-8
        np.testing.assert_allclose(x.grad.numpy() / scale, b / scale, atol=1e-3, err_msg=name)


def _edge_inputs(cz, seed, B=1, L=16, H=8):
    """tests/test_torch_widths.py's EdgeTransition inputs at B = 1."""
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (rng.normal(size=s) * sc).astype(np.float32)
    hid = 3 * cz
    p = {"k1": f(hid, hid, sc=0.05), "b1": f(hid, sc=0.1), "k2": f(hid, hid, sc=0.05),
         "b2": f(hid, sc=0.1), "k3": f(hid, cz, sc=0.05), "b3": f(cz, sc=0.1),
         "ln_scale": 1 + f(cz, sc=0.1), "ln_bias": f(cz, sc=0.1)}
    readout = (f(cz, H, sc=0.1), f(H), f(cz, cz // 4, sc=0.1), f(cz // 4))
    mask = (rng.random((B, L)) > 0.1).astype(np.float32)
    return f(B, L, L, cz), f(B, L, cz), mask, p, readout


def _near_tie_rows(edge, node_bias, p, tol=1e-4):
    """Pair rows (B, L, L) whose float64 h1 or h2 has an entry within `tol`
    int8 levels of a half-level tie: h1 = relu([e | n_i | n_j].k1 + b1), h2
    = relu((q1.W2q) s1 w2s + b2) from h1's exact levels q1."""
    d = {k: v.astype(np.float64) for k, v in p.items()}
    B, L, _, cz = edge.shape
    x = np.concatenate([edge, np.broadcast_to(node_bias[:, :, None], edge.shape),
                        np.broadcast_to(node_bias[:, None], edge.shape)], -1).astype(np.float64)

    def levels(h):
        amax = np.abs(h).max(-1, keepdims=True)
        return h * np.where(amax > 0, 127.0 / np.where(amax > 0, amax, 1.0), 0.0), amax / 127.0

    h1 = np.maximum(x @ d["k1"] + d["b1"], 0.0)
    lv1, s1 = levels(h1)
    w2q, w2s = (t.double().numpy() for t in cuda_edge.quant_cols(torch.from_numpy(p["k2"])))
    h2 = np.maximum((np.round(lv1) @ w2q) * s1 * w2s + d["b2"], 0.0)
    lv2, _ = levels(h2)
    near = lambda lv: (np.abs(np.abs(lv - np.floor(lv)) - 0.5) < tol).any(-1)
    return near(lv1) | near(lv2)


@pytest.mark.parametrize("cz", [128, 512])
def test_int8_plain_matches_jax_kernel(cz):
    edge, nb, mask, p, ro = _edge_inputs(cz, cz)
    want = jax_edge(jnp.asarray(edge), jnp.asarray(nb), jnp.asarray(mask),
                    {k: jnp.asarray(v) for k, v in p.items()}, dtype=jnp.float32,
                    quant_int8=True, interpret=True, readout=tuple(jnp.asarray(x) for x in ro))
    got = cuda_edge.edge_transition_int8_plain(T(edge), T(nb), T(mask),
                                               {k: T(v) for k, v in p.items()}, torch.float32,
                                               readout=tuple(T(x) for x in ro))
    # Each output's error a pair row (i, j): the readouts are (B, n, L, L).
    err = np.abs(got[0].numpy() - np.asarray(want[0])).max(-1)
    for a, b in zip(got[1:], want[1:]):
        err = np.maximum(err, np.abs(a.numpy() - np.asarray(b)).max(1))
    beyond = err > 1e-5
    ties = _near_tie_rows(edge, nb, p)
    assert not (beyond & ~ties).any(), np.argwhere(beyond & ~ties)
    assert beyond.sum() <= 0.02 * beyond.size, int(beyond.sum())
    assert err.max() < 5e-2
