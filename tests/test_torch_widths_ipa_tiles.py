"""The wide fused-IPA kernels' schedule (csrc/ipa2_wide.cu: K7 and K8 at C
= 256, 512, 1024, CZ4 = 32, 64, 128), emulated in plain PyTorch on the CPU
against the plain versions ``cuda_ipa.ipa2_plain`` and ``ipa2_bwd_plain``.

The CUDA kernels cannot run here, so the functions below repeat what the
entry points launch, in order, on the layouts and scratch the wrapper
passes (``cuda_ipa.wide_scratch``):

- the inputs read through the 18 element strides of the wrapper's layout
  (qp, kvp, bias, pz), in the sampler's layouts (the pair bias (B, H, L, L),
  the pair readout a view of (B, CZ4, L, L)) and training's (the bias a view
  of (B, L, L, H), the readout (B, L, L, CZ4));
- the (B, H, L, L) matrices in rows of Lp = L rounded up to 8, their padding
  columns filled with NaN: the TT GEMMs read 16-byte chunks past L there,
  and only output columns past L may see them;
- the row kernels' sums as a warp takes them (lane j % 32 adds its keys in
  order, then the xor butterfly), the pair kernel's key groups (channel
  t % CZ4 of thread t over keys t / CZ4 + 256 / CZ4 n, the groups added in
  order), the column kernel's warps (query rows w + 8 n, then the warps in
  order), the heads' partials of the frame gradient added in head order.

Tolerances: the forward's point and pair outputs within 1e-4 (fp32 sums
in another order); the scalar output o within 1e-2, with at most 1% of
its entries beyond 1e-4: a weight a whose fp32 value, summed in another
order, lies at a bf16 rounding boundary rounds to the other neighbour in
bf16(a).v and moves the C entries of o of its query row and head by a
bf16 step of a times |v| (0.04% of the entries beyond 1e-4 at C = 512, up
to 4.1e-4; 0.29% at C = 1024, up to 3.2e-3); each gradient within 1e-4
of its norm (the same flips in bf16(gs)). A wrong stride, row map,
transposed copy or lost partial moves an output by O(1).
"""

import numpy as np
import pytest
import torch

from pepflowww_torch.models import cuda_ipa

from test_torch_ipa2 import _inputs

torch.set_num_threads(1)
H, PQ, PV = 8, 8, 12
bf = torch.bfloat16
rnd = lambda t: t.to(bf).float()


def warp_sum(x):
    """Sum over the last axis as a warp takes it: lane j % 32 adds its
    entries in order, then the lanes' partials go through the xor butterfly
    (every lane ends with lane 0's value)."""
    n = x.shape[-1]
    x = torch.nn.functional.pad(x, (0, -n % 32)).reshape(*x.shape[:-1], -1, 32)
    acc = x[..., 0, :]
    for m in range(1, x.shape[-2]):
        acc = acc + x[..., m, :]
    lane = torch.arange(32)
    for m in (16, 8, 4, 2, 1):
        acc = acc + acc[..., lane ^ m]
    return acc[..., 0]


def read(t, strides, *idx):
    """t's elements at the index tensors `idx` through `strides`, as the
    kernels address the storage under a permuted view."""
    flat = (t._base if t._base is not None else t).reshape(-1)
    return flat[sum(i * s for i, s in zip(idx, strides))].float()


def layouts(ins, layout):
    """bf16 inputs in the module's layouts and the strides the kernels get
    (cuda_ipa._LAYOUT's order: qp 5, kvp 5, bias 4, pz 4)."""
    q, kv, qp, kvp, r9, t, bias, pz, maskb, sw = [torch.from_numpy(np.asarray(x)) for x in ins]
    qp = qp.permute(0, 3, 2, 1, 4).to(bf).contiguous().permute(0, 3, 2, 1, 4)
    kvp = kvp.permute(0, 3, 2, 1, 4).to(bf).contiguous().permute(0, 3, 2, 1, 4)
    if layout == "sampler":
        bias, pz = bias.to(bf), pz.permute(0, 3, 1, 2).to(bf).contiguous().permute(0, 2, 3, 1)
    else:
        bias, pz = bias.permute(0, 2, 3, 1).to(bf).contiguous().permute(0, 3, 1, 2), pz.to(bf)
    args = [q.to(bf), kv.to(bf), qp, kvp, r9, t, bias, pz, maskb, sw]
    st = list(cuda_ipa._LAYOUT(*qp.stride(), *kvp.stride(), *bias.stride(), *pz.stride()))
    return args, {"qp": st[:5], "kvp": st[5:10], "bias": st[10:14], "pz": st[14:]}


def points(args, lay):
    """ipaw_points_kernel: (qg, kg, vg) (B, H, L, 3, P) and |qg|^2, |kg|^2."""
    q, kv, qp, kvp, r9, t, bias, pz, maskb, sw = args
    B, L = r9.shape[:2]
    b, h, l = torch.meshgrid(torch.arange(B), torch.arange(H), torch.arange(L), indexing="ij")
    R, T = r9[b, l], t[b, l]

    def pts(x, st, p0, n, scale):
        out, s = torch.zeros(B, H, L, 3, n), torch.zeros(B, H, L)
        for p in range(n):
            v = [read(x, st, b, h, d, l, p0 + p) for d in range(3)]
            for c in range(3):
                u = (R[..., 3 * c] * v[0] + R[..., 3 * c + 1] * v[1] + R[..., 3 * c + 2] * v[2]
                     + T[..., c]) * scale
                out[..., c, p] = u
                s = s + u * u
        return out, s

    swh = sw.reshape(1, H, 1)
    qg, qsq = pts(qp, lay["qp"], 0, PQ, swh)
    kg, ksq = pts(kvp, lay["kvp"], 0, PQ, swh)
    vg, _ = pts(kvp, lay["kvp"], PQ, PV, 1.0)
    return qg, kg, vg, qsq, ksq


def gemm_tt(scratch, L, Bm, alpha=1.0):
    """A TT GEMM of wide_gemm.cuh over the L rows of a [B H][Lp][Lp]
    scratch (columns past L read, then dropped): out[b, h, m] = alpha
    sum_k A[k][m] Bm[b, h, k]."""
    out = torch.einsum("bhkm,bhkc->bhmc", scratch[:, :, :L, :], Bm) * alpha
    return out[:, :, :L]


def heads(x, C):
    """(B, L, H C) -> (B, H, L, C)."""
    B, L = x.shape[:2]
    return x.float().reshape(B, L, H, C).transpose(1, 2)


def row_kernel(args, lay, pts, C, eps, cots=None):
    """GEMM S = s1 q.k^T, then ipaw_row_kernel: a (B, H, L, L), the point
    aggregation (B, H, L, 3, PV), its local points and norms; with the
    cotangents, gl and goptg and the inverse transform's row partial."""
    q, kv, qp, kvp, r9, t, bias, pz, maskb, sw = args
    B, L = q.shape[:2]
    qg, kg, vg, qsq, ksq = pts
    s1, s2 = (1.0 / np.sqrt(3.0 * C)), 0.57735026918962573
    S = torch.einsum("bhic,bhjc->bhij", heads(q, C), heads(kv, 2 * C)[..., :C]) * np.float32(s1)
    b, h, i, j = torch.meshgrid(*(torch.arange(n) for n in (B, H, L, L)), indexing="ij")
    dot = torch.einsum("bhik,bhjk->bhij", qg.flatten(-2), kg.flatten(-2))
    pt = qsq[..., :, None] + ksq[..., None, :] - 2.0 * dot
    s = S + read(bias, lay["bias"], b, h, i, j) * np.float32(s2) - 0.5 * pt + maskb[:, :, None, :]
    e = torch.exp(s - s.amax(-1, keepdim=True))
    a = e / warp_sum(e)[..., None]
    ov = warp_sum((a[..., None] * vg.flatten(-2)[:, :, None]).transpose(-1, -2))   # (B,H,L,36)
    ov = ov.reshape(B, H, L, 3, PV)
    R = r9.reshape(B, L, 3, 3)[:, None]                                   # R[d][c]
    dif = ov - t[:, None, :, :, None]
    loc = torch.einsum("bhldc,bhldp->bhlcp", R.expand(-1, H, -1, -1, -1), dif)
    nrm = torch.sqrt(eps + loc[..., 0, :] ** 2 + loc[..., 1, :] ** 2 + loc[..., 2, :] ** 2)
    if cots is None:
        return a, loc, nrm
    go, goptl, gnorm, gopair = cots
    gl = goptl.reshape(B, L, 3, H, PV).permute(0, 3, 1, 2, 4) \
        + loc * (gnorm.reshape(B, L, H, PV).transpose(1, 2)[:, :, :, None] / nrm[:, :, :, None])
    goptg = torch.einsum("bhldc,bhlcp->bhldp", R.expand(-1, H, -1, -1, -1), gl)
    rt = torch.cat([torch.einsum("bhldp,bhlcp->bhldc", dif, gl).flatten(-2),
                    -goptg.sum(-1)], -1)                                  # (B,H,L,12)
    return a, goptg, rt


def forward(args, lay, C, cz4, eps=1e-8):
    """ipa2_wide_forward's five launches."""
    q, kv = args[:2]
    B, L = q.shape[:2]
    Lp = -(-L // 8) * 8
    a, loc, nrm = row_kernel(args, lay, points(args, lay), C, eps)
    acT = torch.full((B, H, Lp, Lp), float("nan"))
    acT[:, :, :L, :L] = rnd(a).transpose(-1, -2)                        # [j][i]
    o = gemm_tt(acT, L, heads(kv, 2 * C)[..., C:])
    # ipaw_pair_kernel: channel d of thread t, keys t / cz4 + njg n, groups in order.
    njg = 256 // cz4
    b, i, j, d = torch.meshgrid(*(torch.arange(n) for n in (B, L, L, cz4)), indexing="ij")
    pzv = read(args[7], lay["pz"], b, i, j, d)                           # (B, L(i), L(j), cz4)
    part = [torch.einsum("bhij,bijd->bihd", a[..., g::njg], pzv[:, :, g::njg]) for g in range(njg)]
    opair = part[0]
    for p in part[1:]:
        opair = opair + p
    return (o.transpose(1, 2).reshape(B, L, H * C),
            loc.permute(0, 2, 3, 1, 4).reshape(B, L, 3 * H * PV),
            nrm.transpose(1, 2).reshape(B, L, H * PV), opair.reshape(B, L, H * cz4))


def backward(args, lay, cots, C, cz4, eps=1e-8):
    """ipa2_wide_backward's twelve launches."""
    q, kv, qp, kvp, r9, t, bias, pz, maskb, sw = args
    go, goptl, gnorm, gopair = cots
    B, L = q.shape[:2]
    Lp = -(-L // 8) * 8
    s1, s2 = np.float32(1.0 / np.sqrt(3.0 * C)), np.float32(0.57735026918962573)
    pts = points(args, lay)
    qg, kg, vg = (x.flatten(-2) for x in pts[:3])
    gob = rnd(go)
    G = torch.einsum("bhic,bhjc->bhij", heads(gob, C), heads(kv, 2 * C)[..., C:])
    a, goptg, rtq = row_kernel(args, lay, pts, C, eps, cots)
    # ipaw_pair_kernel, backward: the pair term a thread a key (channels in
    # order, a sum a head), gpz heads in order.
    b, i, j, d = torch.meshgrid(*(torch.arange(n) for n in (B, L, L, cz4)), indexing="ij")
    pzv = read(pz, lay["pz"], b, i, j, d)
    gop = gopair.reshape(B, L, H, cz4)
    term = torch.zeros(B, H, L, L)
    for dd in range(cz4):
        term = term + gop[..., dd].transpose(1, 2)[..., None] * pzv[..., dd][:, None]
    G = G + term
    gpz = torch.zeros(B, L, L, cz4)
    for hh in range(H):
        gpz = gpz + a[:, hh][..., None] * gop[:, :, hh][:, :, None, :]
    # ipaw_grad_row_kernel
    ga = G + torch.einsum("bhik,bhjk->bhij", goptg.flatten(-2), vg)
    gs = a * (ga - warp_sum(a * ga)[..., None])
    gq_pts = warp_sum((gs[..., None] * kg[:, :, None]).transpose(-1, -2))    # (B,H,L,24)
    rs = warp_sum(gs)
    gqg = (-rs[..., None] * qg + gq_pts).reshape(B, H, L, 3, PQ)
    R = r9.reshape(B, L, 3, 3)[:, None].expand(-1, H, -1, -1, -1)          # R[c][d]
    swh = sw.reshape(1, H, 1, 1)

    def tfm(gu, x, scale):
        """(the points' gradient (B, H, 3, L, P), the rows' gR | gT (B, H, L, 12))."""
        gx = torch.einsum("bhlcd,bhlcp->bhdlp", R, gu) * scale[..., None]
        rt = torch.cat([torch.einsum("bhdlp,bhlcp->bhlcd", x, gu).flatten(-2) * scale,
                        gu.sum(-1) * scale], -1)
        return gx, rt

    bi, hi, di, li, pi = torch.meshgrid(*(torch.arange(n) for n in (B, H, 3, L, PQ + PV)),
                                        indexing="ij")
    xkv = read(kvp, lay["kvp"], bi, hi, di, li, pi)
    xq = read(qp, lay["qp"], bi[..., :PQ], hi[..., :PQ], di[..., :PQ], li[..., :PQ], pi[..., :PQ])
    gqp, rt_q = tfm(gqg, xq, swh)
    rtq = rtq + rt_q
    swq = (gqg * qg.reshape(B, H, L, 3, PQ)).sum((-2, -1))
    # ipaw_col_kernel: warp w over query rows w + 8 n, the warps in order.
    acc = None
    for w in range(8):
        part = torch.cat([torch.einsum("bhij,bhik->bhjk", a[:, :, w::8], goptg.flatten(-2)[:, :, w::8]),
                          torch.einsum("bhij,bhik->bhjk", gs[:, :, w::8], qg[:, :, w::8]),
                          gs[:, :, w::8].sum(2)[..., None]], -1)
        acc = part if acc is None else acc + part
    gvg = acc[..., :3 * PV].reshape(B, H, L, 3, PV)
    gkg = (-acc[..., -1:] * kg + acc[..., 3 * PV:-1]).reshape(B, H, L, 3, PQ)
    gk_pts, rt_k = tfm(gkg, xkv[..., :PQ], swh)
    gv_pts, rt_v = tfm(gvg, xkv[..., PQ:], torch.ones(1, H, 1, 1))
    swk = (gkg * kg.reshape(B, H, L, 3, PQ)).sum((-2, -1))
    # The TT GEMMs over padded bf16 copies (NaN padding columns).
    pad = lambda x: torch.nn.functional.pad(rnd(x), (0, Lp - L, 0, Lp - L), value=float("nan"))
    gsc, gsct, ac = pad(gs), pad(gs.transpose(-1, -2)), pad(a)
    gq = gemm_tt(gsct, L, heads(kv, 2 * C)[..., :C], s1)
    gk = gemm_tt(gsc, L, heads(q, C), s1)
    gv = gemm_tt(ac, L, heads(gob, C))
    # ipaw_finish_kernel: heads in order; rows in order.
    rt = torch.zeros(B, L, 12)
    for hh in range(H):
        rt = rt + (rtq[:, hh] + (rt_k + rt_v)[:, hh])
    sws = torch.zeros(B, H)
    for ll in range(L):
        sws = sws + (swq[..., ll] + swk[..., ll])
    return (gq.transpose(1, 2).reshape(B, L, H * C),
            torch.cat([gk, gv], -1).transpose(1, 2).reshape(B, L, 2 * H * C), gqp,
            torch.cat([gk_pts, gv_pts], -1), rt[..., :9], rt[..., 9:], gs * s2, gpz,
            sws / sw.reshape(1, H))


@pytest.mark.parametrize("C,L,layout", [(256, 37, "sampler"), (512, 64, "train"),
                                        (1024, 100, "train"), (256, 1, "sampler")])
def test_wide_schedule_matches_plain(C, L, layout):
    cz4 = C // 8
    args, lay = layouts(_inputs(B=2, L=L, H=H, C=C, Pq=PQ, Pv=PV, CZ4=cz4, seed=C + L), layout)
    want = cuda_ipa.ipa2_plain(*args)
    for name, x, y in zip(("o", "optl", "norm", "opair"), forward(args, lay, C, cz4), want):
        assert torch.isfinite(x).all(), name
        err = (x - y).abs()
        if name == "o":
            assert float(err.max()) <= 1e-2 and float((err > 1e-4).float().mean()) <= 1e-2
        else:
            np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-4, rtol=1e-5, err_msg=name)
    rng = np.random.default_rng(L)
    cots = [torch.from_numpy(rng.normal(size=o.shape).astype(np.float32)) for o in want]
    want = cuda_ipa.ipa2_bwd_plain(*args, *cots)
    names = ("gq", "gkv", "gqp", "gkvp", "gr9", "gt", "gbias", "gpz", "gsw")
    for name, x, y in zip(names, backward(args, lay, cots, C, cz4), want):
        assert x.shape == y.shape and torch.isfinite(x).all(), name
        assert float((x - y).norm()) <= 1e-4 * float(y.norm()) + 1e-6, name


def test_wide_scratch_and_bounds():
    """The wrapper's scratch (wide_scratch) at the largest shapes the
    width sweep and the L = 128 step run, the kernels' limits, and the
    width checks' routing."""
    mib = lambda d: sum(np.prod(s) * torch.tensor([], dtype=dt).element_size()
                        for s, dt in d.values()) / 2**20
    fwd, bwd = cuda_ipa.wide_scratch(64, 64, 256, False), cuda_ipa.wide_scratch(64, 64, 256, True)
    assert list(fwd) == ["P", "S", "ac"]
    assert list(bwd) == ["P", "S", "G", "gob", "ac", "gsc", "gsct", "GO", "RTq", "RTk", "SWq", "SWk"]
    assert bwd["S"][0] == (64 * H * 64, 64) and cuda_ipa.wide_scratch(3, 37, 512, True)["S"][0] == \
        (3 * H * 37, 40)
    # The backward's scratch at B=64, L=64 (2x) and B=16, L=128: tens of MiB
    # (62.75 and 45.4), not GiB.
    assert mib(bwd) < 64 and mib(cuda_ipa.wide_scratch(16, 128, 256, True)) < 64
    # The pair kernel's dynamic shared memory at the longest L (csrc/ipa2_wide.cu
    # pair_smem) fits a block's 227 KB; the column kernel's is fixed.
    L = cuda_ipa.WIDE_MAX_L
    assert 4 * (H * L + H * 256) <= 232448 and 4 * (H * L + H * 128) <= 232448
    assert 4 * 8 * (3 * PV + 3 * PQ + 1) * 32 <= 232448
    z = lambda *s: torch.zeros(*s)
    for C, cz4, wide in ((128, 16, False), (256, 32, True), (1024, 128, True)):
        assert cuda_ipa.check_widths(H, C, PQ, PV, cz4) is wide
        assert cuda_ipa._check_widths(z(1, 4, H * C), z(1, H, 3, 4, PQ), z(1, H, 3, 4, PQ + PV),
                                      z(1, 4, 4, cz4)) == (H, C, cz4, wide)
    with pytest.raises(ValueError, match="L <= 4096"):
        cuda_ipa._check_widths(z(1, L + 1, H * 256), z(1, H, 3, 1, PQ), z(1, H, 3, 1, PQ + PV),
                               z(1, 1, 1, 32))
