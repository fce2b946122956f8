"""The schedule of the EdgeTransition backward kernel (K4,
``csrc/edge_transition_bwd.cu``), emulated in plain PyTorch on the CPU,
against ``cuda_edge.edge_transition_bwd_plain`` and the JAX package's
``edge_transition_bwd`` (Pallas, interpret mode).

The CUDA kernels cannot run here, so :func:`edge_bwd_tiled` repeats what
they do and in which order, with the launcher's own split of the work
(``cuda_edge.bwd_schedule``):

- the chain kernel walks tiles of 8 x 8 pairs (i, j) of one batch row, pairs
  past L zero-filled; per tile the recompute and the backward chain at the
  JAX kernel's rounding points, dx as one accumulation of bf16(do).W3^T and
  bf16(da1).W1^T; each tile's column sums of da1, da2, do, g'y and g' are
  added into the partial of the block that owns the tile (tiles 2 z + wg +
  2 k grid), the blocks' partials summed in order; the node terms leave as
  partials, a tile row's sum of dx[64:128] over its 8 j (slot jb of row i)
  and a warp's sum of dx[128:192] over its 2 i (slot 4 ib + warp of column
  j);
- the weight kernel sums C^T.bf16(da1), bf16(h1)^T.bf16(da2) and
  bf16(r)^T.bf16(do) over chunks of tiles, one partial per chunk, n1, n2, n3
  chunks for the three;
- the reduction adds every partial in a fixed order.

Further tests check the index maps the kernels rely on (wgmma.cuh): an
accumulator third packed to bf16 is the A operand of the next product; the
K-major weight panels read MN-major (transpose-B) through desc_sw128_mn;
the tile images the chain kernel writes, read by the weight kernel as
MN-major A and B (transpose-A and -B, B's three panels LBO apart); the
butterfly that sums a quad column's eight lanes.

Tolerances. Against ``edge_transition_bwd_plain`` (the same rounding
points, fp32 sums in another order): each gradient within 1e-4 of its norm.
These inputs differ by ~2e-7; the bound leaves room for an operand (h1, r,
do, da2 or da1, summed in another order before its rounding) that rounds to
the other bf16 neighbour in one of the two, which moves one term of a sum of
thousands by one bf16 step (~7e-5 of the norm at B=3, L=37). Against the JAX
kernel in interpret mode: within 1e-2 of the norm, tests/test_torch_grad.py's
bound for the bf16 backward.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pepflowww_tpu.models.pallas_edge_bwd import edge_transition_bwd as jax_edge_bwd

from pepflowww_torch.models import cuda_edge

torch.set_num_threads(1)
CZ, HID, TI, TM = 64, 192, 8, 64
NAMES = cuda_edge.PARAM_NAMES
bf = torch.bfloat16


def _inputs(B, L, seed):
    """Module-layout inputs from numpy: bf16 edge, node bias and cotangent
    (as the kernel takes them), a node mask with ~10% zeros, fp32 weights."""
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: torch.from_numpy((rng.normal(size=s) * sc).astype(np.float32))
    p = {"k1": f(HID, HID, sc=0.1), "b1": f(HID, sc=0.1), "k2": f(HID, HID, sc=0.1),
         "b2": f(HID, sc=0.1), "k3": f(HID, CZ, sc=0.1), "b3": f(CZ, sc=0.1),
         "ln_scale": 1 + f(CZ, sc=0.1), "ln_bias": f(CZ, sc=0.1)}
    mask = torch.from_numpy((rng.random((B, L)) > 0.1).astype(np.float32))
    return f(B, L, L, CZ).to(bf), f(B, L, CZ).to(bf), mask, p, f(B, L, L, CZ).to(bf)


def edge_bwd_tiled(edge, node_bias, node_mask, p, g, sms=132, eps=1e-5):
    """K4's schedule in plain PyTorch (see the module docstring). Returns
    (d_edge, d_node, {name: grad}), float32."""
    rnd = lambda t: t.to(bf).float()
    B, L = edge.shape[:2]
    grid, (n1, n2, n3), ntiles, nbi = cuda_edge.bwd_schedule(B, L, sms)
    e, n, gg = rnd(edge), rnd(node_bias), rnd(g)
    k1, k2, k3 = rnd(p["k1"]), rnd(p["k2"]), rnd(p["k3"])
    m = node_mask.float()
    images = {k: torch.zeros(ntiles, TM, w) for k, w in
              (("C", HID), ("h1", HID), ("r", HID), ("do", CZ), ("da2", HID), ("da1", HID))}
    tile_vec = torch.zeros(ntiles, 2 * HID + 3 * CZ)
    rowpart = torch.zeros(B * L, nbi, CZ)
    colpart = torch.zeros(B * L, 4 * nbi, CZ)
    d_edge = torch.zeros(B, L, L, CZ)
    rows = torch.arange(TM)
    for t in range(ntiles):
        b, rem = divmod(t, nbi * nbi)
        ib, jb = divmod(rem, nbi)
        i, j = ib * TI + rows // TI, jb * TI + rows % TI      # row r: pair (b, i, j)
        valid = (i < L) & (j < L)
        ic, jc = i.clamp(max=L - 1), j.clamp(max=L - 1)
        v = valid.float()[:, None]
        x = torch.cat([e[b, ic, jc], n[b, ic], n[b, jc]], -1) * v
        a1 = x @ k1 + p["b1"]
        h1 = rnd(torch.relu(a1))
        a2 = h1 @ k2 + p["b2"]
        r = rnd(torch.relu(a2) + x)
        o = r @ k3 + p["b3"]
        mu = o.mean(-1, keepdim=True)
        inv = torch.rsqrt((o - mu).square().mean(-1, keepdim=True) + eps)
        y = (o - mu) * inv
        gp = gg[b, ic, jc] * (m[b, ic] * m[b, jc] * valid.float())[:, None]
        dy = gp * p["ln_scale"]
        do = (dy - dy.mean(-1, keepdim=True) - y * (dy * y).mean(-1, keepdim=True)) * inv
        doc = rnd(do)
        da2 = (doc @ k3.t()) * (a2 > 0)
        da1 = (rnd(da2) @ k2.t()) * (a1 > 0)
        dx = doc @ k3.t() + rnd(da1) @ k1.t()
        for name, val in (("C", x), ("h1", h1), ("r", r), ("do", doc), ("da2", rnd(da2)),
                          ("da1", rnd(da1))):
            images[name][t] = val
        tile_vec[t] = torch.cat([da1.sum(0), da2.sum(0), do.sum(0), (gp * y).sum(0), gp.sum(0)])
        d_edge[b, i[valid], j[valid]] = dx[valid, :CZ]
        for ii in range(TI):                       # a tile row: its 8 j
            if ib * TI + ii < L:
                rowpart[b * L + ib * TI + ii, jb] = dx[ii * TI:(ii + 1) * TI, CZ:2 * CZ].sum(0)
        for w in range(4):                         # a warp: rows 2w, 2w + 1 of each column
            for jj in range(TI):
                if jb * TI + jj < L:
                    colpart[b * L + jb * TI + jj, 4 * ib + w] = (
                        dx[(2 * w) * TI + jj, 2 * CZ:] + dx[(2 * w + 1) * TI + jj, 2 * CZ:])
    # The chain kernel's blocks: warpgroup wg of block z takes tiles 2 z + wg,
    # + 2 grid, ...; a block's partial is the sum of its tiles'.
    vpart = torch.zeros(grid, 2 * HID + 3 * CZ)
    for t in range(ntiles):
        vpart[(t // 2) % grid] += tile_vec[t]
    vec = torch.zeros(2 * HID + 3 * CZ)
    for z in range(grid):
        vec += vpart[z]

    def chunked(a_img, b_img, nch):               # one partial a chunk, summed in order
        out = 0
        for z in range(nch):
            t0, t1 = ntiles * z // nch, ntiles * (z + 1) // nch
            A, Bm = a_img[t0:t1].reshape(-1, a_img.shape[-1]), b_img[t0:t1].reshape(-1, b_img.shape[-1])
            out = out + A.t() @ Bm
        return out

    grads = {"k1": chunked(images["C"], images["da1"], n1),
             "k2": chunked(images["h1"], images["da2"], n2),
             "k3": chunked(images["r"], images["do"], n3),
             "b1": vec[:HID], "b2": vec[HID:2 * HID], "b3": vec[2 * HID:2 * HID + CZ],
             "ln_scale": vec[2 * HID + CZ:2 * HID + 2 * CZ], "ln_bias": vec[2 * HID + 2 * CZ:]}
    d_node = (rowpart.sum(1) + colpart.sum(1)).reshape(B, L, CZ)
    return d_edge, d_node, grads


def _close_in_norm(got, want, rel, tag):
    for name, a, b in zip(("d_edge", "d_node") + NAMES, got, want):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        assert np.isfinite(a).all(), f"{tag} {name}: non-finite"
        err = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
        assert err <= rel, f"{tag} {name}: {err:.3e} of the norm, beyond {rel}"


def _flat(res):
    d_edge, d_node, grads = res
    return [d_edge, d_node] + [grads[k] for k in NAMES]


@pytest.mark.parametrize("B,L,sms", [(3, 37, 132), (2, 64, 16), (1, 1, 132)])
def test_tiled_schedule_matches_plain(B, L, sms):
    """Tiles cut at both edges with a pair count that is no multiple of 64
    (B=3, L=37), whole tiles with more tiles than blocks (L=64 on 16 SMs, so
    a block sums several tiles and each weight chunk several), and a single
    pair."""
    edge, nb, mask, p, g = _inputs(B, L, seed=B * 100 + L)
    got = edge_bwd_tiled(edge, nb, mask, p, g, sms=sms)
    want = cuda_edge.edge_transition_bwd_plain(edge, nb, mask, p, g, torch.bfloat16)
    _close_in_norm(_flat(got), _flat(want), 1e-4, f"B={B} L={L}")


def test_tiled_schedule_matches_jax_kernel():
    """At the JAX kernel's shapes (B=2, L=16) the emulated schedule agrees
    with the Pallas backward kernel in interpret mode, fed the same
    bf16-rounded values."""
    B, L = 2, 16
    edge, nb, mask, p, g = _inputs(B, L, seed=7)
    got = edge_bwd_tiled(edge, nb, mask, p, g)
    j = lambda t: jnp.asarray(t.float().numpy())
    d_edge, d_node, d_p = jax_edge_bwd(j(edge).astype(jnp.bfloat16), j(nb).astype(jnp.bfloat16),
                                       j(mask), {k: j(v) for k, v in p.items()}, j(g),
                                       dtype=jnp.bfloat16, interpret=True)
    want = [d_edge, d_node] + [d_p[k] for k in NAMES]
    _close_in_norm(_flat(got), want, 1e-2, "vs JAX")


def _swizzle(addr):
    """The 128-byte swizzle on byte addresses (Swizzle<3,4,3>): bits 4-6 ^= bits 7-9."""
    return addr ^ (((addr >> 7) & 7) << 4)


def _kmajor_image(M):
    """A matrix [rows][cols] (cols a multiple of 64) as the kernels stage it
    K-major: panel c // 64, row r, 16-byte chunk (c % 64) // 8 at chunk
    position chunk ^ (r % 8) (sw128_offset); as int64 bf16 elements."""
    rows, cols = M.shape
    panel = rows * 128
    img = np.zeros(cols // 64 * panel // 2, np.int64)
    for r in range(rows):
        for c in range(0, cols, 8):
            byte = (c // 64) * panel + r * 128 + ((((c % 64) // 8) ^ (r % 8)) << 4)
            img[byte // 2:byte // 2 + 8] = M[r, c:c + 8]
    return img


def _mn_major(img, start, lbo, k, n):
    """Element (k, n) of an MN-major operand read through desc_sw128_mn(start,
    lbo): 64 consecutive n in a 128-byte row, K rows 128 bytes apart in
    groups of 8 that lie 1024 bytes apart, blocks of 64 n lbo apart."""
    addr = start + (n % 64) * 2 + (n // 64) * lbo + (k % 8) * 128 + (k // 8) * 1024
    return img[_swizzle(addr) // 2]


def test_fragment_and_swizzle_maps():
    """(1) A third of an m64n64 accumulator (32 fp32 a thread), packed as
    bf16 pairs, is A operand steps 4p .. 4p + 3 of the next product in
    h[16p .. 16p + 15]. (2) W^T [out][in] staged K-major (the forward's copy)
    read MN-major from panel p + 2048 s with SBO 1024 is B[k][n] = W^T[16s +
    k][64p + n], the third p of dy.W^T. (3) A tile image the chain kernel
    writes (store_image: rows 16 warp + g and + 8, columns 8j + 2q) is the
    K-major panel layout, and the weight kernel's reads of it are A^T[m][k]
    = X[16s + k][64w + m] from panel w (transpose-A) and B[k][n] = Y[16s +
    k][n] over three panels 8192 bytes apart (transpose-B, N = 192)."""
    def acc_pos(w, g, q, idx):   # row, column of n64 accumulator entry idx
        jb, rr = divmod(idx, 4)
        return 16 * w + g + 8 * (rr // 2), 8 * jb + 2 * q + rr % 2

    def afrag_pos(w, g, q, reg, half):   # row, depth column of an A-fragment half
        return 16 * w + g + 8 * (reg % 2), 8 * (reg // 2) + 2 * q + half

    for w in range(4):
        for lane in range(32):
            g, q = divmod(lane, 4)
            for p in range(3):
                for u in range(8):               # h[2(8p + u)] row a, h[2(8p + u) + 1] row b
                    for rr in range(4):
                        reg = 2 * (8 * p + u) + rr // 2
                        st, rg = divmod(reg, 4)
                        row, col = acc_pos(w, g, q, 4 * u + rr)
                        frow, fcol = afrag_pos(w, g, q, rg, rr % 2)
                        assert (row, 64 * p + col) == (frow, 16 * st + fcol)

    rng = np.random.default_rng(0)
    for out, inn in ((CZ, HID), (HID, HID)):     # W3^T, W2^T (and W1^T)
        Wt = rng.integers(0, 1 << 15, size=(out, inn)).astype(np.int64)
        img = _kmajor_image(Wt)
        for p in range(inn // 64):
            for s in range(out // 16):
                start = p * out * 128 + s * 2048
                for k in range(16):
                    for nn in range(0, 64, 7):
                        assert _mn_major(img, start, out * 128, k, nn) == Wt[16 * s + k, 64 * p + nn]

    X = rng.integers(0, 1 << 15, size=(TM, HID)).astype(np.int64)
    panel = TM * 128
    img = np.zeros(3 * panel // 2, np.int64)     # store_image's positions
    for w in range(4):
        for g in range(8):
            ra = 16 * w + g
            for q in range(4):
                for jb in range(24):
                    for row in (ra, ra + 8):
                        byte = (jb // 8) * panel + row * 128 + (((jb % 8) ^ g) << 4) + 4 * q
                        img[byte // 2:byte // 2 + 2] = X[row, 8 * jb + 2 * q:8 * jb + 2 * q + 2]
    assert np.array_equal(img, _kmajor_image(X))
    for s in range(TM // 16):
        for k in range(16):
            for mm in range(0, 64, 5):
                for w in range(3):               # A^T of warpgroup w, M = 64
                    assert _mn_major(img, w * panel + s * 2048, panel, k, mm) == X[16 * s + k, 64 * w + mm]
            for nn in range(0, HID, 5):          # B over the three panels, N = 192
                assert _mn_major(img, s * 2048, panel, k, nn) == X[16 * s + k, nn]


def test_quad_column_butterfly():
    """quad_column_sum: each of the eight lanes of a quad column (lane = 4g
    + q) starts with eight entries; after the exchanges over lane bits 4, 3,
    2 (the lane with the bit set keeping the upper half) lane g holds the
    sum over the eight lanes of entry g, which is column 8 (g / 2) + 2q + g %
    2 of the four 8-column blocks the entries cover."""
    col = lambda e, q: 8 * (e >> 1) + 2 * q + (e & 1)   # entry e = 2u + c: column 8u + 2q + c
    vals = np.array([[100.0 * col(e, lane % 4) + lane // 4 for e in range(8)] for lane in range(32)])
    v = vals.copy()
    n = 8
    for m in (16, 8, 4):
        nxt = v.copy()
        for lane in range(32):
            up, other = bool(lane & m), lane ^ m
            for k in range(n // 2):
                keep = v[lane, k + n // 2] if up else v[lane, k]
                send = v[other, k] if (other & m) else v[other, k + n // 2]
                nxt[lane, k] = keep + send
        v, n = nxt, n // 2
    for lane in range(32):
        g, q = divmod(lane, 4)
        assert v[lane, 0] == 8 * 100.0 * (8 * (g // 2) + 2 * q + g % 2) + sum(range(8))
