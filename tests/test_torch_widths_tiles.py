"""The wide kernels' schedule (c_z = F = 128, 256: csrc/wide_gemm.cuh,
wide_dist.cuh and the ``*_wide_*`` entry points of edge_transition.cu,
distance_embed.cu and distance_embed_bwd.cu), emulated in plain PyTorch on
the CPU against the plain versions. The EdgeTransition forward's tile
kernel (csrc/edge_wide.cuh) is emulated by
tests/test_torch_widths_edge_fused.py's ``fused_forward``, held here to the
plain version at c_z 128 and 256 as well; the backward's
(edge_transition_bwd.cu) by tests/test_torch_widths_edge_bwd_fused.py.

The CUDA kernels cannot run here, so the functions below repeat what the
entry points launch, in order, on the operands ``kernel_operands`` packs:

- every GEMM reads its operands as the kernels' ``Opd`` does (column
  segments, each from its own source, pair rows gathered to residue rows
  b L + i or b L + j: :func:`operand`), with the entry points' segment
  lists, K and N, and applies its epilogue in the same order (per-residue
  terms, then the bias, ReLU, masks, rounding);
- column sums of the DA / DA2D epilogues in blocks of 128 pair rows, the
  weight gradients in K slices of ``wide_kslice`` pairs: each as partials
  added in ``wide_reduce_kernel``'s fixed order;
- the distance table gradient a residue at a time into 22 rows by aa_j,
  then a token and chunk of 64 residues at a time, then the chunks'
  partials.

Tolerances. Forward outputs (bf16) within 1e-2: a hidden activation whose
fp32 sum, taken in another order, rounds to the other bf16 neighbour moves
an output by about one bf16 step (4e-3 at |x| ~ 1). Gradients within 3e-4
of the plain gradient's norm: the same kind of flip in a sum of thousands
of terms (tests/test_torch_edge_bwd_tiles.py allows 1e-4), here more of
them (the wide schedules' bound: in the EdgeTransition backward, whose
first layer is factorized, 9 of 129,792 entries of h1 at B L^2 = 338 pairs
round to the other bf16 neighbour, which moves dW1 by 1.3e-4 of its norm).
A wrong segment, row map or lost partial moves a gradient by O(1) of its
norm.
"""

import numpy as np
import pytest
import torch

from pepflowww_torch.models import cuda_dist, cuda_edge

from test_torch_widths_edge_fused import fused_forward

torch.set_num_threads(1)
bf = torch.bfloat16
ROW, NODE_I, NODE_J = 0, 1, 2
SMS = 132
rnd = lambda t: t.to(bf).float()


def seg(t, ld, start=0, gather=ROW):
    return (t.reshape(-1), ld, gather, start)


def operand(segs, rows, cols, L):
    """The [rows][cols] matrix the kernels' opd_at reads: columns [start_k,
    start_k+1) from segment k, its row r the source row r, r / L or (r / L^2)
    L + r % L."""
    r = torch.arange(rows)
    out = torch.empty(rows, cols)
    ends = [s[3] for s in segs[1:]] + [cols]
    for (flat, ld, gather, start), end in zip(segs, ends):
        src = r if gather == ROW else r // L if gather == NODE_I else (r // (L * L)) * L + r % L
        out[:, start:end] = flat[src[:, None] * ld + torch.arange(end - start)[None, :]].float()
    return out


def nt(A, B, M, N, K, L):
    """C[m][n] = sum_k A(m, k) B(n, k)."""
    return operand(A, M, K, L) @ operand(B, N, K, L).t()


def reduce_slots(parts):
    """wide_reduce_kernel's order: warp w of 8 adds slots w, w + 8, ... in
    order, then the warps' sums are added in warp order."""
    warps = []
    for w in range(8):
        acc = torch.zeros_like(parts[0])
        for p in parts[w::8]:
            acc = acc + p
        warps.append(acc)
    out = warps[0]
    for acc in warps[1:]:
        out = out + acc
    return out


def tt_slots(A, B, M, N, K, L, ks):
    """sum_k A(k, m) B(k, n) over K slices of ks pairs, one slot a slice."""
    a, b = operand(A, K, M, L), operand(B, K, N, L)
    return reduce_slots([a[k0:k0 + ks].t() @ b[k0:k0 + ks] for k0 in range(0, K, ks)])


def colsum_blocks(v, rows=128):
    """Column sums of v, one partial row a block of `rows` rows."""
    return reduce_slots([v[r0:r0 + rows].sum(0) for r0 in range(0, v.shape[0], rows)])


def pair_rows(B, L):
    r = torch.arange(B * L * L)
    return r // L, (r // (L * L)) * L + r % L


def _edge_inputs(cz, B, L, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: torch.from_numpy((rng.normal(size=s) * sc).astype(np.float32))
    hid = 3 * cz
    p = {"k1": f(hid, hid, sc=0.05), "b1": f(hid, sc=0.1), "k2": f(hid, hid, sc=0.05),
         "b2": f(hid, sc=0.1), "k3": f(hid, cz, sc=0.05), "b3": f(cz, sc=0.1),
         "ln_scale": 1 + f(cz, sc=0.1), "ln_bias": f(cz, sc=0.1)}
    readout = (f(cz, 8, sc=0.1), f(8), f(cz, cz // 4, sc=0.1), f(cz // 4))
    mask = torch.from_numpy((rng.random((B, L)) > 0.1).astype(np.float32))
    return (f(B, L, L, cz).to(bf), f(B, L, cz).to(bf), mask, p, readout,
            f(B, L, L, cz).to(bf))


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30))


@pytest.mark.parametrize("cz", [128, 256])
def test_wide_edge_forward_schedule(cz):
    B, L = 2, 13   # a ragged 128-row block: B L^2 = 338 pair rows
    edge, nb, mask, p, ro, _ = _edge_inputs(cz, B, L, cz + 1)
    ops = cuda_edge.kernel_operands(p, ro)
    lanes = -(-(8 + cz // 4) // 64) * 64
    assert ops["wrt"].shape == (lanes, cz) and not ops["wrt"][8 + cz // 4:].any()
    want = cuda_edge.edge_transition_plain(edge, nb, mask, p, bf)
    torch.testing.assert_close(fused_forward(edge, nb, mask, ops, None).float(), want.float(),
                               atol=1e-2, rtol=0)
    want = cuda_edge.edge_transition_plain(edge, nb, mask, p, bf, readout=ro)
    for name, a, b in zip(("out", "b", "pz"), fused_forward(edge, nb, mask, ops, ro), want):
        assert a.shape == b.shape, name
        torch.testing.assert_close(a.float(), b.float(), atol=1e-2, rtol=0, msg=name)


def _dist_inputs(F_, B, L, seed):
    rng = np.random.default_rng(seed)
    f = lambda x: torch.from_numpy(np.asarray(x, np.float32))
    args = (f(rng.normal(size=(B, L, 15, 3)) * 0.5), f(rng.random((B, L, 15)) > 0.15),
            torch.from_numpy(rng.integers(0, 22, size=(B, L))), f(rng.random((B, L)) > 0.2))
    p = {"table": f(rng.normal(size=(484, 225))), "k1": f(rng.normal(size=(225, F_)) * 0.07),
         "b1": f(rng.normal(size=F_) * 0.1), "k2": f(rng.normal(size=(F_, F_)) * 0.08),
         "b2": f(rng.normal(size=F_) * 0.1)}
    return args, p, f(rng.normal(size=(B, L, L, F_))).to(bf)


def dist_x(pos, amask, aa, table):
    """wide_dist_x_kernel: the gaussian rows, 256 wide, and the pieces the
    table gradient reuses (d2, the atom-pair mask, the coefficient rows)."""
    B, L = aa.shape
    sp = torch.where(table > 20, table, torch.log1p(torch.exp(table)))   # wide_softplus_kernel
    d2 = ((pos[:, :, None, :, None] - pos[:, None, :, None, :]) ** 2).sum(-1).reshape(-1, 225)
    mp = (amask[:, :, None, :, None] * amask[:, None, :, None, :]).reshape(-1, 225)
    idx = (aa[:, :, None] * 22 + aa[:, None, :]).reshape(-1)
    x = torch.zeros(B * L * L, 256)
    x[:, :225] = rnd(torch.exp(-sp[idx] * d2) * mp)
    return x, d2, mp, idx, sp


def dist_forward_wide(pos, amask, aa, smask, ops):
    B, L = aa.shape
    f_, M = ops["k2"].shape[0], B * L * L
    ri, rj = pair_rows(B, L)
    x = dist_x(pos, amask, aa, ops["table"])[0]
    h = rnd(torch.relu(nt([seg(x, 256)], [seg(ops["k1t"], 256)], M, f_, 256, L) + ops["b1"]))
    s = smask.reshape(-1)
    o = torch.relu(nt([seg(h, f_)], [seg(ops["k2t"], f_)], M, f_, f_, L) + ops["b2"])
    return rnd(o * (s[ri] * s[rj])[:, None]).reshape(B, L, L, f_)


def dist_backward_wide(pos, amask, aa, smask, ops, g, chunk=64):
    B, L = aa.shape
    f_, M, nres = ops["k2"].shape[0], B * L * L, B * L
    ri, rj = pair_rows(B, L)
    x, d2, mp, idx, sp = dist_x(pos, amask, aa, ops["table"])
    hc = rnd(torch.relu(nt([seg(x, 256)], [seg(ops["k1t"], 256)], M, f_, 256, L) + ops["b1"]))
    a2 = nt([seg(hc, f_)], [seg(ops["k2t"], f_)], M, f_, f_, L) + ops["b2"]
    s = smask.reshape(-1)
    da2 = g.reshape(M, f_).float() * (s[ri] * s[rj])[:, None] * (a2 > 0)
    da2c = rnd(da2)
    da1 = nt([seg(da2c, f_)], [seg(ops["k2"], f_)], M, f_, f_, L) * (hc > 0)
    da1c = rnd(da1)
    dx = nt([seg(da1c, f_)], [seg(ops["k1p"], f_)], M, 256, f_, L)
    coef = ops["table"][idx]
    dcoef = dx[:, :225] * mp * torch.exp(-sp[idx] * d2) * (-d2) * torch.sigmoid(coef)
    # wide_dcoef_kernel: residue n's pairs into 22 rows by aa_j, j in order.
    tok = aa.reshape(-1)
    part1 = torch.zeros(nres, 22, 225)
    for n in range(nres):
        b = n // L
        for j in range(L):
            part1[n, tok[b * L + j]] += dcoef[n * L + j]
    # wide_table_kernel: a token and chunk of residues, then the chunks in order.
    part2 = []
    for c0 in range(0, nres, chunk):
        p2 = torch.zeros(22, 22, 225)
        for n in range(c0, min(nres, c0 + chunk)):
            p2[tok[n]] += part1[n]
        part2.append(p2.reshape(484, 225))
    d_table = reduce_slots(part2)
    ks1 = cuda_edge.wide_kslice(M, 256, f_, SMS)
    ks2 = cuda_edge.wide_kslice(M, f_, f_, SMS)
    return {"table": d_table,
            "k1": tt_slots([seg(x, 256)], [seg(da1c, f_)], 256, f_, M, L, ks1)[:225],
            "b1": colsum_blocks(da1),
            "k2": tt_slots([seg(hc, f_)], [seg(da2c, f_)], f_, f_, M, L, ks2),
            "b2": colsum_blocks(da2)}


def test_wide_dist_schedule():
    """K3 and K5 at F = 128; (B, L) = (3, 11) puts two batch rows' residues
    in one 64-residue chunk of the table sum and ragged 128-row blocks."""
    args, p, g = _dist_inputs(128, 3, 11, 5)
    ops = cuda_dist.kernel_operands(p)
    torch.testing.assert_close(dist_forward_wide(*args, ops).float(),
                               cuda_dist.distance_embed_plain(*args, p, bf).float(),
                               atol=1e-2, rtol=0)
    got = dist_backward_wide(*args, ops, g, chunk=cuda_dist.WIDE_CHUNK)
    want = cuda_dist.distance_embed_bwd_plain(*args, p, g, bf)
    for k in cuda_dist.PARAM_NAMES:
        assert _rel(got[k], want[k]) <= 3e-4, k


def test_wide_schedule_bounds():
    """The wide EdgeTransition backward's schedule at every width and batch
    of the sweep: the chain kernel's grid one block an SM at most and one a
    64-pair tile, its weight-gradient slots (2 c_z hid + hid^2 fp32 a K
    slice) under 32 MB, its whole scratch (images, per-residue sums,
    partials) within 1.0 / 1.0 / 0.5 GB at w = 2 / 4 / 8; the pair rows fit
    the kernels' 32-bit index. K5's weight-gradient K slices (wide_kslice)
    stay multiples of 64 pairs with at most 64 slots of ~17 MB in all."""
    for cz, B in ((128, 64), (256, 32), (512, 8), (128, 1)):
        M, hid = B * 64 * 64, 3 * cz
        assert M < 2**31
        ntiles = -(-M // 64)
        grid, nslices = cuda_edge.wide_bwd_schedule(B, 64, cz, SMS)
        assert 1 <= grid <= min(SMS, ntiles) and 1 <= nslices <= ntiles
        assert nslices * (2 * cz * hid + hid * hid) * 4 <= 32e6, (cz, B, nslices)
        scratch = sum(n * dt.itemsize for n, dt in
                      cuda_edge.wide_bwd_scratch(B, 64, cz, grid, nslices))
        assert scratch <= {128: 1.0e9, 256: 1.0e9, 512: 0.5e9}[cz], (cz, B, scratch)
        for rows, cols in ((225, cz), (cz, cz)):
            ks = cuda_edge.wide_kslice(M, rows, cols, SMS)
            slots = -(-M // ks)
            assert ks % 64 == 0 and 1 <= slots <= 64
            assert slots * rows * cols * 4 <= 20e6, (cz, B, rows, cols, slots)
