"""The schedule of the fused IPA backward kernels (K8, ``csrc/ipa2_bwd.cu``),
emulated in plain PyTorch on the CPU, against ``cuda_ipa.ipa2_bwd_plain``
and the JAX package's ``fused_ipa2_bwd`` (Pallas, interpret mode).

The CUDA kernels cannot run here, so a function repeats what they do and in
which order, in the training step's input layouts (the pair bias a view
of (B, L, L, H), the pair features (B, L, L, CZ4)):

- :func:`two_kernels` (L <= 64): the tile kernel, a block per (b, h) on the
  whole 64 x 64 tile, rows and keys past L zero-filled and masked (a = 0
  there); the logits of the bf16 values in fp32, the softmax over the one
  tile with a = exp(s - m) · (1/l); optg, goptl', goptg and the inverse
  transform's d R, d t per row; g_a = bf16(go)·vᵀ + goptg·vgᵀ + gopair·pz;
  D, gs, gbias; gq = bf16(gs)·k, gk = bf16(gs)ᵀ·q, gv = bf16(a)ᵀ·bf16(go);
  the fp32 point gradients and frame backwards, and each head's per-residue
  d R, d t as partials. Then the pair kernel, a block per (b, 8 query
  rows): each head's weights of the rows recomputed (the row's sum of exp
  as four warps' partials added in order), gpz = Σ_h a_h gopair_h and gr9,
  gt from the partials, heads in order 0 .. H-1.

A further test checks the index maps the kernels rely on (wgmma.cuh,
ipa2_tile.cuh), for L <= 64 and for the three kernels of L > 64
(tests/test_torch_ipa2_bwd_long.py emulates their schedule): the gs (and a)
accumulator packed to bf16 as the A operand of gq (gk, gv); K, Q and
bf16(go), staged as load_tile places them, read as MN-major B; the bf16 gs
and a panels the tile kernel writes from its accumulators, read as MN-major
A (transpose-A); the fp32 tiles' row permutation (sw64); the pair kernels'
mma.sync fragments and key maps (8 rows against 64 keys for L <= 64, 16
rows against chunks of 32 keys above).

Tolerances, each gradient as ‖got − want‖ ≤ tol·‖want‖ (the card's form,
``chip_smoke.compare_grads``), against ``ipa2_bwd_plain`` (the same rounding
points, fp32 sums in another order) and against the JAX kernel in interpret
mode alike. gq and gkv, the products of bf16(gs) and bf16(a): 5e-3. A gs
that rounds to the other bf16 neighbour in one of the two moves its term by
2^-8 of it, and these peaked weights leave one term most of its row; at
L=100, 13 of the 20,000 gs flip and gq differs by 1.5e-3 of its norm (where
none flips, ≤ 1.3e-6). Every other gradient is fp32 from the fp32 a and gs:
1e-4 (measured ≤ 7.8e-6). The card's check is 1e-2 of the norm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pepflowww_tpu.models import pallas_ipa2 as P

from pepflowww_torch.models import cuda_ipa

torch.set_num_threads(1)
H, C, PQ, PV, CZ4 = 2, 128, 8, 12, 16
TQ = cuda_ipa.TILE                              # rows of a tile
RB = 8                                          # query rows a block of the pair kernel (L <= 64)
PANEL = TQ * 128                                # bytes of a 64-row panel of 64 bf16 channels
NAMES = ("gq", "gkv", "gqp", "gkvp", "gr9", "gt", "gbias", "gpz", "gsw")
TOL = {"gq": 5e-3, "gkv": 5e-3}       # the bf16 products; every other gradient 1e-4
INF = float("inf")


def _rotmats(v):
    """Rotation matrices of rotation vectors `v` (..., 3), Rodrigues'
    formula, float32."""
    th = np.linalg.norm(v, axis=-1)[..., None, None]
    k = v / np.linalg.norm(v, axis=-1, keepdims=True)
    K = np.zeros(v.shape + (3,))
    K[..., 0, 1], K[..., 0, 2], K[..., 1, 2] = -k[..., 2], k[..., 1], -k[..., 0]
    K = K - np.swapaxes(K, -1, -2)
    return (np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K).astype(np.float32)


def _inputs(B, L, seed):
    """Training-layout inputs and the cotangents of the four outputs, from
    numpy: bf16 where the model feeds bf16, the points as permuted views of
    (B, L, 3, H, P), the bias a view of (B, L, L, H); ~15% of the keys
    masked."""
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: torch.from_numpy((rng.normal(size=s) * sc).astype(np.float32))
    bf = torch.bfloat16
    R = torch.from_numpy(_rotmats(rng.normal(size=(B, L, 3))).reshape(B, L, 9))
    mask = rng.uniform(size=(B, L)) > 0.15
    mask[:, 0] = True
    maskb = torch.from_numpy((1e5 * (mask.astype(np.float32) - 1.0))[:, None, :])
    qp = f(B, L, 3, H, PQ, sc=2.0).to(bf).permute(0, 3, 2, 1, 4)
    kvp = f(B, L, 3, H, PQ + PV, sc=2.0).to(bf).permute(0, 3, 2, 1, 4)
    bias = f(B, L, L, H).to(bf).permute(0, 3, 1, 2)
    args = [f(B, L, H * C).to(bf), f(B, L, 2 * H * C).to(bf), qp, kvp, R, f(B, L, 3, sc=5.0),
            bias, f(B, L, L, CZ4).to(bf), maskb, f(1, H, sc=0.1).abs() + 0.2]
    cots = [f(B, L, H * C), f(B, L, 3 * H * PV), f(B, L, H * PV), f(B, L, H * CZ4)]
    return args, cots


class _Geo:
    """What both schedules take from the inputs, float32, head-major:
    frames R (B, L, 3, 3), t (B, L, 3); global points qg, kg (scaled by sw),
    vg (B, H, L, 3P) as [x | y | z]; q, k, v, bf16(go) (B, H, L, C); the
    bias (B, H, L, L), the pair features (B, L, L, CZ4), the key masks
    (B, L); the cotangents per head: goptl (B, H, L, 3, PV), gnorm (B, H, L,
    PV), gopair (B, H, L, CZ4)."""

    def __init__(self, args, cots):
        q, kv, qp, kvp, r9, t, bias, pz, maskb, sw = args
        go, goptl, gnorm, gopair = cots
        B, L = q.shape[:2]
        self.B, self.L = B, L
        self.R = r9.float().reshape(B, L, 3, 3)
        self.t = t.float()
        self.sw = sw.float().reshape(H)
        self.x = (qp.float(), kvp[..., :PQ].float(), kvp[..., PQ:].float())
        swb = self.sw.reshape(1, H, 1, 1)
        self.qg, self.kg = self.glob(self.x[0], swb), self.glob(self.x[1], swb)
        self.vg = self.glob(self.x[2], 1.0)
        self.q = q.float().reshape(B, L, H, C).transpose(1, 2)
        kvh = kv.float().reshape(B, L, H, 2 * C).transpose(1, 2)
        self.k, self.v = kvh[..., :C], kvh[..., C:]
        self.go = go.to(torch.bfloat16).float().reshape(B, L, H, C).transpose(1, 2)
        self.bias, self.pz, self.mb = bias.float(), pz.float(), maskb.float()[:, 0]
        self.goptl = goptl.reshape(B, L, 3, H, PV).permute(0, 3, 1, 2, 4)
        self.gnorm = gnorm.reshape(B, L, H, PV).transpose(1, 2)
        self.gopair = gopair.reshape(B, L, H, CZ4).transpose(1, 2)
        self.s1, self.s2 = 1.0 / (3 * C) ** 0.5, 1.0 / 3.0 ** 0.5

    def glob(self, x, scale):   # (B, H, 3, L, P) -> (B, H, L, 3P): (Σ_d R[c, d] x_d + t_c)·scale
        R, t = self.R, self.t
        cs = [(R[:, None, :, c, 0, None] * x[:, :, 0] + R[:, None, :, c, 1, None] * x[:, :, 1]
               + R[:, None, :, c, 2, None] * x[:, :, 2] + t[:, None, :, c, None]) * scale
              for c in range(3)]
        return torch.cat(cs, -1)

    def logits(self, i, j):
        """s over query rows i and key rows j (ranges), fp32."""
        qg, kg = self.qg[:, :, i], self.kg[:, :, j]
        return (self.q[:, :, i] @ self.k[:, :, j].transpose(-1, -2) * self.s1
                + self.bias[:, :, i, j] * self.s2
                - 0.5 * (qg.square().sum(-1, keepdim=True) + kg.square().sum(-1)[:, :, None]
                         - 2.0 * qg @ kg.transpose(-1, -2))
                + self.mb[:, None, None, j])

    def goptg(self, optg, i, eps=1e-8):
        """From the point sums optg (B, H, n, 36) of query rows i: goptg
        (B, H, n, 36) and the inverse transform's per-head d R, d t (B, H,
        n, 12)."""
        R, t = self.R[:, None, i], self.t[:, None, i]     # (B, 1, n, 3, 3), (B, 1, n, 3)
        dif = optg.reshape(*optg.shape[:3], 3, PV) - t[..., None]     # [d][p]
        loc = torch.einsum("bhndc,bhndp->bhncp", R.expand(-1, H, -1, -1, -1), dif)
        nrm = torch.sqrt(loc.square().sum(3) + eps)                   # (B, H, n, PV)
        gl = self.goptl[:, :, i] + loc * self.gnorm[:, :, i, None] / nrm[:, :, :, None]
        gg = torch.einsum("bhndc,bhncp->bhndp", R.expand(-1, H, -1, -1, -1), gl)
        dR = torch.einsum("bhndp,bhncp->bhndc", dif, gl).reshape(*optg.shape[:3], 9)
        return gg.reshape(optg.shape), torch.cat([dR, -gg.sum(-1)], -1)

    def pair_term(self, i, j):
        """Σ_d gopair_h[i, d] pz[i, j, d] (B, H, n, m)."""
        return torch.einsum("bhid,bijd->bhij", self.gopair[:, :, i], self.pz[:, i][:, :, j])

    def frame_bwd(self, k, gu, rows, scale):
        """Backward of u = (R x + t)·scale for point set k (0 query, 1 key,
        2 value) on rows: gx (B, H, 3, n, P) and per-head d R, d t (B, H, n,
        12)."""
        x = self.x[k][:, :, :, rows]
        P_ = x.shape[-1]
        g = gu.reshape(*gu.shape[:3], 3, P_) * scale                   # [c][p]
        gx = torch.einsum("bncd,bhncp->bhdnp", self.R[:, rows], g)
        dR = torch.einsum("bhdnp,bhncp->bhncd", x, g).reshape(*gu.shape[:3], 9)
        return gx, torch.cat([dR, g.sum(-1)], -1)


def two_kernels(args, cots):
    """The schedule of the tile and pair kernels (L <= 64). Returns the nine
    gradients of ``ipa2_bwd`` in its output layouts, float32."""
    G = _Geo(args, cots)
    B, L = G.B, G.L
    assert L <= TQ
    pad = lambda x, dim: torch.nn.functional.pad(x, [0, 0] * (x.dim() - 1 - dim) + [0, TQ - L])
    rows = slice(0, L)
    # The tile kernel: a block per (b, h) on the 64 x 64 tile.
    s = torch.full((B, H, TQ, TQ), -INF)
    s[:, :, :L, :L] = G.logits(rows, rows)
    m = s.max(-1, keepdim=True).values
    e = torch.where(m == -INF, 0.0, torch.exp(s - m))
    lsum = e.sum(-1, keepdim=True)
    a = e * torch.where(lsum > 0, 1.0 / lsum, 0.0)                   # (B, H, 64, 64), fp32
    vg, qg, kg = pad(G.vg, 2), pad(G.qg, 2), pad(G.kg, 2)
    goptg, row_inv = G.goptg((a @ vg)[:, :, :L], rows)
    goptg, row_inv = pad(goptg, 2), pad(row_inv, 2)
    v, k, q, go = pad(G.v, 2), pad(G.k, 2), pad(G.q, 2), pad(G.go, 2)
    g_a = go @ v.transpose(-1, -2) + goptg @ vg.transpose(-1, -2)
    g_a[:, :, :L, :L] += G.pair_term(rows, rows)
    gs = a * (g_a - (a * g_a).sum(-1, keepdim=True))
    gsc, ac = gs.bfloat16().float(), a.bfloat16().float()
    gq = gsc @ k * G.s1
    gk = gsc.transpose(-1, -2) @ q * G.s1
    gv = ac.transpose(-1, -2) @ go
    gqg = -gs.sum(-1, keepdim=True) * qg + gs @ kg
    gkg = -gs.sum(-2)[..., None] * kg + gs.transpose(-1, -2) @ qg
    gvg = a.transpose(-1, -2) @ goptg
    gsw = ((gqg * qg).sum((2, 3)) + (gkg * kg).sum((2, 3))) / G.sw
    gqp, rq = G.frame_bwd(0, gqg[:, :, :L], rows, G.sw.reshape(1, H, 1, 1, 1))
    gkp, rk = G.frame_bwd(1, gkg[:, :, :L], rows, G.sw.reshape(1, H, 1, 1, 1))
    gvp, rv = G.frame_bwd(2, gvg[:, :, :L], rows, 1.0)
    rowc = row_inv[:, :, :L] + rq + rk + rv                          # (B, H, L, 12) partials
    # The pair kernel: a block per (b, RB rows); each head's weights of the
    # rows recomputed, the row's sum of exp as the four warps' partials of 16
    # keys added in warp order; gpz and the partials summed over heads in order.
    gr = torch.zeros(B, L, 12)
    gpz = torch.zeros(B, L, L, CZ4)
    for r0 in range(0, L, RB):
        i = slice(r0, min(L, r0 + RB))
        for hh in range(H):
            sb = torch.full((B, i.stop - i.start, TQ), -INF)
            sb[..., :L] = G.logits(i, rows)[:, hh]
            mb = sb.max(-1, keepdim=True).values
            eb = torch.where(mb == -INF, 0.0, torch.exp(sb - mb))
            part = eb.reshape(B, -1, 4, 16).sum(-1)
            lb = ((part[..., 0] + part[..., 1]) + part[..., 2]) + part[..., 3]
            ab = eb * torch.where(lb > 0, 1.0 / lb, 0.0)[..., None]
            gpz[:, i] += ab[..., :L, None] * G.gopair[:, hh, i, None, :]
            gr[:, i] += rowc[:, hh, i]
    gkv = torch.cat([gk[:, :, :L], gv[:, :, :L]], -1).transpose(1, 2).reshape(B, L, 2 * H * C)
    return (gq[:, :, :L].transpose(1, 2).reshape(B, L, H * C), gkv, gqp,
            torch.cat([gkp, gvp], -1), gr[..., :9], gr[..., 9:], gs[:, :, :L, :L] * G.s2, gpz,
            gsw)


def _close(got, want, name):
    for n, a, b in zip(NAMES, got, want):
        tol = TOL.get(n, 1e-4)
        a, b = (torch.from_numpy(np.array(x, np.float32)) for x in (a, b))
        assert a.shape == b.shape, f"{name} {n}: shape {tuple(a.shape)} vs {tuple(b.shape)}"
        assert bool(torch.isfinite(a).all()), f"{name} {n}: non-finite"
        rel = float((a - b).norm() / b.norm().clamp_min(1e-30))
        assert rel <= tol, f"{name} {n}: {rel:.3e} of the norm, beyond {tol}"


@pytest.mark.parametrize("B,L", [(2, 1), (2, 24), (3, 37), (2, 64)])
def test_two_kernel_schedule_matches_plain(B, L):
    """A single key, the nb=6 oracle's L=24, a ragged L and training's
    L=64; at L = 24 and 64 also the JAX kernel (each L compiles it anew in
    interpret mode)."""
    args, cots = _inputs(B, L, seed=L)
    got = two_kernels(args, cots)
    _close(got, cuda_ipa.ipa2_bwd_plain(*args, *cots), f"L={L} vs plain")
    if L in (24, TQ):
        tojax = lambda x: jnp.asarray(x.float().contiguous().numpy()).astype(
            jnp.bfloat16 if x.dtype == torch.bfloat16 else jnp.float32)
        kern = jax.jit(lambda a, c: P.fused_ipa2_bwd(*a, *c, interpret=True))(
            [tojax(x) for x in args], [tojax(x) for x in cots])
        _close(got, kern, f"L={L} vs JAX")


def _swizzle(addr):
    return addr ^ (((addr >> 7) & 7) << 4)        # Swizzle<3,4,3> on byte addresses


def _mn_major(img, start, k, n):
    """Element (k, n) of an MN-major operand read through desc_sw128_mn(start,
    PANEL): 64 consecutive n in a 128-byte row, K rows 128 bytes apart in
    groups of 8 that lie 1024 bytes apart, blocks of 64 n PANEL apart."""
    addr = start + (n % 64) * 2 + (n // 64) * PANEL + (k % 8) * 128 + (k // 8) * 1024
    return img[_swizzle(addr) // 2]


def test_operand_maps():
    """(1) The gs accumulator packed as hs[k] = bf16 pair (gs[2k], gs[2k+1])
    is gq's A operand: step st in hs[4st .. 4st + 3]. (2) A 64 x 128 tile
    staged as load_tile places it (chunk c of row r at panel c // 8,
    sw128_offset(r, c % 8)) — K, Q and bf16(go) — read as MN-major B from
    start p·PANEL + 2048 st is B[k][n] = X[16 st + k][64 p + n]. (3) The bf16
    gs and a panels as the tile kernel writes them (the pair of row ra or
    rb, columns 8j + 2q, at sw128_offset(row, j) + 4q) read as MN-major A
    from 2048 st is A[m][k] = X[16 st + k][m], i.e. Xᵀ: key m, query 16 st +
    k. (4) sw64 permutes each row of a [64][64] fp32 tile by 16-byte groups.
    (5) The pair kernel's m16n8k16 products: with q and K rows as 32-bit
    bf16 pairs (row stride LDR / 2 words), lane (g, q) of warp w reading
    a = (q[g][8kk + q], 0, q[g][8kk + 4 + q], 0) and b = K[16w + 8t + g]
    [8kk + q], [8kk + 4 + q] gets, over kk < 8, d[e] = q_g . k_j for j =
    16w + 8t + 2q + e; the four warps' keys cover 0 .. 63 once, and the
    reads of a warp fall on 32 distinct banks. (6) The pair kernel of L >
    64 (16 rows, keys in chunks of 32): with a = (q[g][8kk + q], q[g + 8]
    [8kk + q], q[g][8kk + 4 + q], q[g + 8][8kk + 4 + q]) and b = K[8w + g]
    [8kk + q], [8kk + 4 + q], lane (g, q) of warp w gets d[2r + e] = q_(g +
    8r) . k_j for j = 8w + 2q + e; the four warps cover the 16 x 32 (row,
    key) pairs once, and a warp's reads of q and K fall on 32 distinct
    banks."""
    def acc_pos(w, g, q, idx):   # row, column of accumulator entry idx
        j, r = divmod(idx, 4)
        return 16 * w + g + 8 * (r // 2), 8 * j + 2 * q + r % 2

    def afrag_pos(w, g, q, reg, half):   # row, depth column of an A-fragment half
        return 16 * w + g + 8 * (reg % 2), 8 * (reg // 2) + 2 * q + half

    for w in range(4):
        for lane in range(32):
            g, q = divmod(lane, 4)
            for st in range(4):
                for reg in range(4):
                    for half in range(2):
                        assert acc_pos(w, g, q, 2 * (4 * st + reg) + half) == \
                            (lambda r, c: (r, 16 * st + c))(*afrag_pos(w, g, q, reg, half))

    rng = np.random.default_rng(0)
    X = rng.integers(0, 1 << 15, size=(TQ, C)).astype(np.int64)
    img = np.zeros(2 * PANEL // 2, np.int64)
    for r in range(TQ):
        for c in range(C // 8):
            byte = (c // 8) * PANEL + r * 128 + (((c % 8) ^ (r % 8)) << 4)
            img[byte // 2:byte // 2 + 8] = X[r, 8 * c:8 * c + 8]
    for p in range(2):
        for st in range(TQ // 16):
            for k in range(16):
                for n in range(0, 64, 3):
                    assert _mn_major(img, p * PANEL + st * 2048, k, n) == X[16 * st + k, 64 * p + n]

    Y = rng.integers(0, 1 << 15, size=(TQ, TQ)).astype(np.int64)   # Y[i][j]: gs or a
    img = np.zeros(PANEL // 2, np.int64)
    for w in range(4):
        for g in range(8):
            for q in range(4):
                for row in (16 * w + g, 16 * w + g + 8):
                    for j in range(8):
                        byte = row * 128 + ((j ^ (row % 8)) << 4) + 4 * q
                        img[byte // 2:byte // 2 + 2] = Y[row, 8 * j + 2 * q:8 * j + 2 * q + 2]
    for st in range(TQ // 16):
        for k in range(16):
            for m in range(TQ):
                assert _mn_major(img, st * 2048, k, m) == Y[16 * st + k, m]

    sw64 = lambda r, c: r * TQ + ((((c >> 2) ^ (r & 15)) << 2) | (c & 3))
    idx = np.array([[sw64(r, c) for c in range(TQ)] for r in range(TQ)])
    assert sorted(idx.ravel()) == list(range(TQ * TQ))
    assert all(set(idx[r] // TQ) == {r} for r in range(TQ))

    LDR = C + 8
    Qr, Kr = rng.normal(size=(RB, C)), rng.normal(size=(TQ, C))
    pair = lambda M, row, word: M[row, 2 * word:2 * word + 2]   # the bf16 pair at 32-bit `word`
    keys = []
    for w in range(4):
        for t in range(2):
            D = np.zeros((16, 8))
            for kk in range(C // 16):   # m16n8k16: D += A B, A 16 x 16 (rows 8-15 zero), B 16 x 8
                A, Bm = np.zeros((16, 16)), np.zeros((16, 8))
                for lane in range(32):
                    g, q = divmod(lane, 4)
                    A[g, 2 * q:2 * q + 2] = pair(Qr, g, 8 * kk + q)               # a[0]
                    A[g, 2 * q + 8:2 * q + 10] = pair(Qr, g, 8 * kk + 4 + q)      # a[2]
                    key = 16 * w + 8 * t + g                                      # B column g
                    Bm[2 * q:2 * q + 2, g] = pair(Kr, key, 8 * kk + q)           # b[0]
                    Bm[2 * q + 8:2 * q + 10, g] = pair(Kr, key, 8 * kk + 4 + q)  # b[1]
                D += A @ Bm
            for lane in range(32):
                g, q = divmod(lane, 4)
                for e in range(2):      # d[e]: row g, column 2q + e
                    j = 16 * w + 8 * t + 2 * q + e
                    keys.append(j)
                    assert abs(D[g, 2 * q + e] - Qr[g] @ Kr[j]) <= 1e-9 * (1 + abs(Qr[g] @ Kr[j]))
        banks = {((16 * w + g) * LDR // 2 + q) % 32 for g in range(8) for q in range(4)}
        assert len(banks) == 32
    assert sorted(keys) == sorted(list(range(TQ)) * RB)

    # (6) The pair kernel of L > 64: 16 rows (both halves of the M rows), a
    # warp's eight keys of a 32-key chunk.
    Q16, K32 = rng.normal(size=(16, C)), rng.normal(size=(32, C))
    pairs = []
    for w in range(4):
        D = np.zeros((16, 8))
        for kk in range(C // 16):
            A, Bm = np.zeros((16, 16)), np.zeros((16, 8))
            for lane in range(32):
                g, q = divmod(lane, 4)
                A[g, 2 * q:2 * q + 2] = pair(Q16, g, 8 * kk + q)                  # a[0]
                A[g + 8, 2 * q:2 * q + 2] = pair(Q16, g + 8, 8 * kk + q)          # a[1]
                A[g, 2 * q + 8:2 * q + 10] = pair(Q16, g, 8 * kk + 4 + q)         # a[2]
                A[g + 8, 2 * q + 8:2 * q + 10] = pair(Q16, g + 8, 8 * kk + 4 + q)  # a[3]
                Bm[2 * q:2 * q + 2, g] = pair(K32, 8 * w + g, 8 * kk + q)         # b[0]
                Bm[2 * q + 8:2 * q + 10, g] = pair(K32, 8 * w + g, 8 * kk + 4 + q)  # b[1]
            D += A @ Bm
        for lane in range(32):
            g, q = divmod(lane, 4)
            for u in range(4):          # d[u]: row g + 8 (u // 2), key 8w + 2q + u % 2
                r, j = g + 8 * (u // 2), 8 * w + 2 * q + u % 2
                pairs.append((r, j))
                want_rj = Q16[r] @ K32[j]
                assert abs(D[r, 2 * q + u % 2] - want_rj) <= 1e-9 * (1 + abs(want_rj))
        for rows in ((g for g in range(8)), (g + 8 for g in range(8))):
            banks = {(r * LDR // 2 + q) % 32 for r in rows for q in range(4)}
            assert len(banks) == 32
        assert len({((8 * w + g) * LDR // 2 + q) % 32 for g in range(8) for q in range(4)}) == 32
    assert sorted(pairs) == [(r, j) for r in range(16) for j in range(32)]
