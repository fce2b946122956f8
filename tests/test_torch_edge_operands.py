"""The EdgeTransition kernels' own arithmetic and operands, on the CPU.

The CUDA kernels compute the first layer and the residual projection on the
concatenated row [e | n_i | n_j] and read K-major weights; the int8 kernel
(K6) also quantizes each hidden row in registers and feeds it to its int8
products in the order it lies there, so its int8 weights have their K axis
permuted (``cuda_edge.INT8_K_PERM``). Each of these is written out here in
torch and held against the JAX package:

- the bf16 kernel's concatenated form against the JAX Pallas kernel in bf16
  (3e-2, one bf16 step of the O(1) outputs) and the plain version in fp32
  (1e-5: the same sums in another order); its K-major copies bit for bit;
- K6's permuted int8 weights, un-permuted, against JAX ``_quant_cols`` bit
  for bit; the register path (an accumulator-ordered row laid out in
  fragment order, times the permuted weights) against the plain integer
  product exactly;
- K6's concatenated form against the JAX int8 kernel in bf16 at
  tests/test_torch_int8.py's tolerance (rtol 8e-3 + atol 1.6e-2, mean abs
  error <= 1e-5), and
  against ``edge_transition_int8_plain`` in fp32 at 1e-5 on every pair row
  whose two row quantizations agree with the plain version's. A row where
  one of them rounds the other way (h1 summed in another order, near a
  half-step or at the row's amax) is counted and not compared: at most 1%
  of the rows may be such;
- the int8 operands are cached per module until a parameter changes.

The CUDA kernels themselves are held against the plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pepflowww_tpu.models.pallas_edge import _quant_cols
from pepflowww_tpu.models.pallas_edge import fused_edge_transition as jax_fused

from pepflowww_torch.models import cuda_edge
from pepflowww_torch.models.layers import cached_operands
from test_torch_edge import (CZ, DZ, H, _inputs, _jax_kernel_params, _node_bias, _port_kernel_params,
                             _port_module)

torch.set_num_threads(1)


def _concat_form(edge, node_bias, node_mask, p, readout, dtype):
    """csrc/edge_transition.cu's arithmetic: operands rounded to `dtype`,
    float32 sums; h1 = relu(x.W1 + b1) and o = x.W3 + h2.W3 + b3 on the
    concatenated row x = [e | n_i | n_j]; LayerNorm, pair mask, rounding;
    the readout from the rounded output, transposed."""
    rnd = lambda t: t.to(dtype).float()
    B, L = edge.shape[:2]
    e, n = rnd(edge), rnd(node_bias)
    x = torch.cat([e, n[:, :, None].expand(B, L, L, -1), n[:, None].expand(B, L, L, -1)], -1)
    k1, k2, k3 = (rnd(p[k]) for k in ("k1", "k2", "k3"))
    h = torch.relu(x @ k1 + p["b1"])
    h = torch.relu(rnd(h) @ k2 + p["b2"])
    o = x @ k3 + rnd(h) @ k3 + p["b3"]
    mu = o.mean(-1, keepdim=True)
    y = (o - mu) * torch.rsqrt((o - mu).square().mean(-1, keepdim=True) + 1e-5)
    y = y * p["ln_scale"] + p["ln_bias"]
    out = rnd(y * (node_mask[:, :, None] * node_mask[:, None, :])[..., None])
    kb, bb, kdz, bdz = readout
    return (out, rnd(out @ rnd(kb) + bb).permute(0, 3, 1, 2),
            rnd(out @ rnd(kdz) + bdz).permute(0, 3, 1, 2))


def test_concat_form_matches_jax_pallas_and_plain():
    """The kernel's concatenated first layer and residual projection give
    the JAX kernel's factorized function: in bf16 within one bf16 step of
    the O(1) outputs (3e-2), in fp32 the plain version within 1e-5."""
    node, edge, mask, params, readout = _inputs(7, B=2, L=16)
    nb = _node_bias(params, node)
    p = _port_kernel_params(params)
    ro = tuple(torch.from_numpy(x) for x in readout)
    args = (torch.from_numpy(edge), torch.from_numpy(nb), torch.from_numpy(mask), p)
    bf = jnp.bfloat16
    want = jax_fused(jnp.asarray(edge).astype(bf), jnp.asarray(nb).astype(bf), jnp.asarray(mask),
                     _jax_kernel_params(params), dtype=bf, interpret=True,
                     readout=tuple(jnp.asarray(x) for x in readout))
    got = _concat_form(*args, ro, torch.bfloat16)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b.astype(jnp.float32)), atol=3e-2)
    got = _concat_form(*args, ro, torch.float32)
    want = cuda_edge.edge_transition_plain(*args, torch.float32, ro)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


def test_kernel_operands_k_major_copies_cached():
    """The bf16 kernels' K-major weights are the bf16 parameters transposed,
    bit for bit, with no second [in, out] copy (the backward kernel reads
    the same ones), and are built once per module until a parameter
    changes."""
    _, _, _, params, readout = _inputs(8)
    m = _port_module(params, dtype=torch.bfloat16, use_kernels=True)
    ro = tuple(torch.from_numpy(x) for x in readout)
    calls = []

    def make():
        calls.append(1)
        return cuda_edge.kernel_operands(m.params(), ro)

    tensors = lambda: list(m.params().values()) + list(ro)
    ops = cached_operands(m, tensors(), make)
    bf = torch.bfloat16
    for k, lin in (("1", m.trunk[0]), ("2", m.trunk[2]), ("3", m.final_layer)):
        t = ops[f"w{k}t"]
        assert t.dtype == bf and t.is_contiguous()
        assert torch.equal(t, lin.weight.detach().to(bf)) and f"k{k}" not in ops
    wr = torch.cat([ro[0], ro[2]], 1).to(bf)
    assert ops["wrt"].shape == (32, CZ) and ops["wrt"].is_contiguous()
    assert torch.equal(ops["wrt"][:H + DZ], wr.t()) and not ops["wrt"][H + DZ:].any()
    assert cached_operands(m, tensors(), make) is ops and len(calls) == 1
    with torch.no_grad():
        m.trunk[0].weight.mul_(2.0)
    ops = cached_operands(m, tensors(), make)
    assert len(calls) == 2 and torch.equal(ops["w1t"], m.trunk[0].weight.detach().to(bf))


def _unpermute(wqt):
    """[out, in] int8 weights with their K axis in the kernel's order, back
    in the natural order."""
    return wqt[:, torch.argsort(cuda_edge.INT8_K_PERM)]


def test_int8_operands_are_jax_quant_cols_permuted():
    """w2qt and w3qt, un-permuted, are JAX's _quant_cols of the float32 k2
    and k3, transposed, bit for bit; the scales too. The permutation stays
    inside each 32-column block (one int8 depth step)."""
    _, _, _, params, readout = _inputs(9)
    ro = tuple(torch.from_numpy(x) for x in readout)
    ops = cuda_edge.kernel_operands(_port_kernel_params(params), ro, quant_int8=True)
    perm = cuda_edge.INT8_K_PERM
    assert sorted(perm.tolist()) == list(range(192))
    assert torch.equal(perm // 32, torch.arange(192) // 32)
    jp = _jax_kernel_params(params)
    for k in ("2", "3"):
        jq, js = _quant_cols(jnp.asarray(jp[f"k{k}"]))
        wqt = ops[f"w{k}qt"]
        assert wqt.dtype == torch.int8 and wqt.is_contiguous()
        np.testing.assert_array_equal(_unpermute(wqt).t().numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ops[f"w{k}s"].numpy(), np.asarray(js).reshape(-1))


def _fragment_order(q):
    """K6's packing of an accumulator-ordered int8 row into wgmma A
    fragments, as csrc/edge_transition.cuh's quant_rows does it: depth step
    s, register 2u (row g) of lane q of a quad holds accumulator blocks j =
    4s + 2u and j + 1, columns 8j + 2q, 8j + 2q + 1, 8(j + 1) + 2q, 8(j + 1)
    + 2q + 1, at fragment columns 32s + 16u + 4q .. + 3."""
    frag = torch.empty_like(q)
    for s in range(q.shape[-1] // 32):
        for u in range(2):
            j = 4 * s + 2 * u
            for lane_q in range(4):
                cols = [8 * j + 2 * lane_q, 8 * j + 2 * lane_q + 1,
                        8 * (j + 1) + 2 * lane_q, 8 * (j + 1) + 2 * lane_q + 1]
                pos = 32 * s + 16 * u + 4 * lane_q
                frag[..., pos:pos + 4] = q[..., cols]
    return frag


def test_register_path_product_is_exact():
    """A hidden row laid out in fragment order times the permuted int8
    weights gives the plain integer product, exactly (int64 sums)."""
    _, _, _, params, _ = _inputs(10)
    p = _port_kernel_params(params)
    ops = cuda_edge.kernel_operands(p, quant_int8=True)
    rng = np.random.default_rng(10)
    q = torch.from_numpy(rng.integers(-127, 128, size=(96, 192)).astype(np.int8))
    q[0] = 127
    q[1] = -127
    frag = _fragment_order(q)
    assert torch.equal(frag, q[:, cuda_edge.INT8_K_PERM])
    for k in ("2", "3"):
        wq, _ = cuda_edge.quant_cols(p[f"k{k}"])
        got = frag.long() @ ops[f"w{k}qt"].long().t()
        assert torch.equal(got, q.long() @ wq.long())
        assert torch.equal(got.float(), cuda_edge._int_product(q, wq))


def _int8_form(edge, node_bias, node_mask, p, readout, dtype, concat=True):
    """K6's arithmetic with `concat`: operands rounded to `dtype`, float32
    sums; h1 = relu(x.W1 + b1) on the concatenated row x = [e | n_i | n_j],
    kept float32 and quantized per row; the int8 products from the fragment
    order and the permuted operands; h2 = relu(float(q1.W2q) * s1 * w2s +
    b2), quantized again; o = float(q2.W3q) * s2 * w3s + x.W3 + b3; the bf16
    function's LayerNorm, mask and readout. Without `concat`, the first
    layer and the residual projection factorized as the plain version has
    them. Returns the outputs and (q1, q2)."""
    rnd = lambda t: t.to(dtype).float()
    B, L = edge.shape[:2]
    e, n = rnd(edge), rnd(node_bias)
    k1, k3 = rnd(p["k1"]), rnd(p["k3"])
    if concat:
        x = torch.cat([e, n[:, :, None].expand(B, L, L, -1), n[:, None].expand(B, L, L, -1)], -1)
        first = lambda k: x @ k
    else:
        def first(k):
            y_i, y_j = cuda_edge._node_terms(n, k, CZ)
            return e @ k[:CZ] + y_i + y_j
    ops = cuda_edge.kernel_operands(p, quant_int8=True)
    perm = cuda_edge.INT8_K_PERM
    product = lambda q, w: q[..., perm].float() @ ops[w].float().t()
    h = torch.relu(first(k1) + p["b1"])
    q1, s1 = cuda_edge.quant_rows(h)
    h = torch.relu(product(q1, "w2qt") * s1 * ops["w2s"] + p["b2"])
    q2, s2 = cuda_edge.quant_rows(h)
    o = product(q2, "w3qt") * s2 * ops["w3s"]
    if concat:
        o = o + first(k3)
    else:
        o = o + e @ k3[:CZ]
        y_i, y_j = cuda_edge._node_terms(n, k3, CZ)
        o = o + y_i + y_j
    out = cuda_edge._output(o + p["b3"], node_mask, p, dtype, readout, 1e-5)
    return out, (q1, q2)


def test_int8_concat_form_matches_jax_and_plain():
    """K6's concatenated form against the JAX int8 kernel (interpret mode) in
    bf16 at rtol 8e-3 + atol 1.6e-2 with a mean abs error <= 1e-5, and
    against the plain version in fp32 at 1e-5 on the rows whose
    quantizations agree (the others counted: at most 1%; 3 of these 2048
    rows)."""
    node, edge, mask, params, readout = _inputs(3)
    nb = _node_bias(params, node)
    p = _port_kernel_params(params)
    ro = tuple(torch.from_numpy(x) for x in readout)
    args = (torch.from_numpy(edge), torch.from_numpy(nb), torch.from_numpy(mask), p)
    bf = jnp.bfloat16
    want = jax_fused(jnp.asarray(edge).astype(bf), jnp.asarray(nb).astype(bf), jnp.asarray(mask),
                     {k: jnp.asarray(v) for k, v in _jax_kernel_params(params).items()},
                     dtype=bf, quant_int8=True, interpret=True,
                     readout=tuple(jnp.asarray(x) for x in readout))
    got, _ = _int8_form(*args, ro, torch.bfloat16)
    for name, a, b in zip(("out", "b", "pz"), got, want):
        assert a.dtype == torch.bfloat16, name
        a, b = a.float().numpy(), np.asarray(b.astype(jnp.float32))
        np.testing.assert_allclose(a, b, rtol=8e-3, atol=1.6e-2, err_msg=name)
        assert np.abs(a - b).mean() <= 1e-5, name

    got, (q1, q2) = _int8_form(*args, ro, torch.float32)
    fact, (f1, f2) = _int8_form(*args, ro, torch.float32, concat=False)
    plain = cuda_edge.edge_transition_int8_plain(*args, torch.float32, ro)
    for a, b in zip(fact, plain):
        assert torch.equal(a, b)
    flipped = (q1 != f1).any(-1) | (q2 != f2).any(-1)          # (B, L, L) pair rows
    assert int(flipped.sum()) <= 0.01 * flipped.numel(), int(flipped.sum())
    keep = ~flipped
    out, b, pz = got
    np.testing.assert_allclose(out[keep].numpy(), plain[0][keep].numpy(), rtol=0, atol=1e-5)
    for a, w in ((b, plain[1]), (pz, plain[2])):   # (B, C, L, L): rows are the last two axes
        np.testing.assert_allclose(a.permute(0, 2, 3, 1)[keep].numpy(),
                                   w.permute(0, 2, 3, 1)[keep].numpy(), rtol=0, atol=1e-5)


def test_int8_operands_cached_per_module():
    """An int8 EdgeTransition's kernel operands are built once until a
    parameter changes, and are what the int8 kernel reads: K-major bf16 W1
    and W3, permuted int8 W2 and W3 with their scales, the readout as wrt,
    no bf16 k1/k2/k3 and no node-product scratch operand."""
    _, _, _, params, readout = _inputs(12)
    m = _port_module(params, dtype=torch.bfloat16, use_kernels=True)
    ro = tuple(torch.from_numpy(x) for x in readout)
    calls = []

    def make():
        calls.append(1)
        return cuda_edge.kernel_operands(m.params(), ro, quant_int8=True)

    tensors = lambda: list(m.params().values()) + list(ro)
    ops = cached_operands(m, tensors(), make)
    tensor_keys = {k for k, v in ops.items() if torch.is_tensor(v)}
    assert tensor_keys == {"w1t", "b1", "w2qt", "w2s", "b2", "w3t", "w3qt", "w3s", "b3",
                           "ln_scale", "ln_bias", "wrt", "bro"}
    bf = torch.bfloat16
    assert torch.equal(ops["w1t"], m.trunk[0].weight.detach().to(bf))
    assert torch.equal(ops["w3t"], m.final_layer.weight.detach().to(bf))
    wr = torch.cat([ro[0], ro[2]], 1).to(bf)
    assert torch.equal(ops["wrt"][:H + DZ], wr.t()) and not ops["wrt"][H + DZ:].any()
    assert cached_operands(m, tensors(), make) is ops and len(calls) == 1
    with torch.no_grad():
        m.trunk[2].weight.mul_(-1.0)
    ops = cached_operands(m, tensors(), make)
    assert len(calls) == 2
    wq, _ = cuda_edge.quant_cols(m.trunk[2].weight.detach().t())
    assert torch.equal(_unpermute(ops["w2qt"]), wq.t())
