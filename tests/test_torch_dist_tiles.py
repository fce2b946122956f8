"""The schedule of the distance-embedding kernels K3 and K5
(``csrc/distance_tile.cuh``, ``csrc/distance_embed.cu``,
``csrc/distance_embed_bwd.cu``), emulated in plain PyTorch on the CPU,
against ``cuda_dist.distance_embed_plain`` / ``distance_embed_bwd_plain``
and the JAX package's ``fused_distance_embed`` / ``distance_embed_bwd``
(Pallas, interpret mode).

The CUDA kernels cannot run here, so :func:`dist_fwd_tiled` and
:func:`dist_bwd_tiled` repeat what they do and in which order:

- the live residues n = b L + i (s_i != 0) are walked in a stable order by
  token, after which come the others, in a bucket of their own; block z of
  G takes the sorted positions [N_live z / G, N_live (z + 1) / G) (the
  forward: G = min(2 sms, N), the backward ``cuda_dist.bwd_schedule``); the
  order comes from per-thread segments of the tokens (:func:`sorted_items`),
  a count, a scan and a second walk, which is the stable order; the
  forward's output rows of a residue whose s_i is 0 are zeros;
- at each run of equal aa_i a block fills the coefficient slabs softplus *
  log2(e) (and the sigmoid) of the run's 22 table rows; the gaussian is
  2^(-sp2 d2);
- a tile is residue i against 64 residues j (L > 64 in tiles of 64); a row
  is live when j < L and s_j != 0; the backward puts the live rows first,
  sorted stably by aa_j, and residues with s_i = 0 add nothing;
- the backward sums dcoef over each run of equal aa_j of a tile, rows in
  order, into the run's table slab, which leaves as the partial in slot z +
  aa_i; dK1 = x^T.bf16(da1) and dK2 = h^T.bf16(da2) sum over the block's
  tiles, one partial a block; the reduction adds the table partials of the
  blocks whose chunks hold each token, and the weight partials, in block
  order.

A further test checks the operand maps of the products (wgmma.cuh): the one
K1 tile [240][64] in 128-byte swizzled rows, read MN-major as the B operand
of a1 = x.K1 and K-major (two 120-column halves) as the B operand of
dx = bf16(da1).K1^T; the x and da1 panels read MN-major as A = x^T and
B = bf16(da1) of dK1; the bf16 pairs a thread writes into a panel.

Tolerances. Against the plain versions in bf16 (the same rounding points;
sums in another order, exp as 2^(-sp log2(e) d2), which differs from exp(-c
d2) in the last bits): the forward within 2e-2 of its O(1) outputs
(measured ≤ 3.9e-3: an x or h that rounds to the other bf16 neighbour moves
an output by a bf16 step of a term); each gradient within 2e-3 of its norm
(measured ≤ 6.1e-4 at B=2, L=100, where 16 of the x elements round the
other way; one sign of a2 that flips moves a column of db2 by |g|, and a
table row sums only ~40 pairs). Against the JAX kernels in float32,
interpret mode, where no bf16 rounding can flip: the forward at 2e-4
(measured ≤ 4.2e-7) and the gradients at rtol 1e-3, atol 1e-4 (measured ≤
2.9e-5), the bounds of tests/test_torch_dist.py and tests/test_torch_grad.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as Fn

from pepflowww_tpu.models.pallas_dist import distance_embed_bwd as jax_dist_bwd
from pepflowww_tpu.models.pallas_dist import fused_distance_embed as jax_dist_fwd

from pepflowww_torch.models import cuda_dist

torch.set_num_threads(1)
A, AA2, KP, NF, NAA, TJ = 15, 225, 240, 64, 22, 64
NAMES = cuda_dist.PARAM_NAMES
LOG2E = 1.4426950408889634
bf = torch.bfloat16


def _inputs(B, L, seed, one_token=False):
    """Module-layout inputs from numpy: positions in nm, atom masks, tokens
    (all one value with `one_token`), structure masks with ~20% zeros (the
    first residue of each row kept, so that L = 1 has a live pair), fp32
    weights, a bf16 cotangent."""
    rng = np.random.default_rng(seed)
    f = lambda x: torch.from_numpy(np.asarray(x, np.float32))
    pos = f(rng.normal(size=(B, L, A, 3)) * 0.5)
    amask = f(rng.random((B, L, A)) > 0.15)
    aa = torch.from_numpy(np.full((B, L), 7) if one_token else rng.integers(0, NAA, size=(B, L)))
    smask = f(rng.random((B, L)) > 0.2)
    smask[:, 0] = 1.0
    p = {"table": f(rng.normal(size=(NAA * NAA, AA2)) * 0.5),
         "k1": f(rng.normal(size=(AA2, NF)) * 0.07), "b1": f(rng.normal(size=NF) * 0.1),
         "k2": f(rng.normal(size=(NF, NF)) * 0.12), "b2": f(rng.normal(size=NF) * 0.1)}
    g = f(rng.normal(size=(B, L, L, NF))).to(bf)
    return (pos, amask, aa, smask), p, g


def sorted_items(aa_flat, s_flat, nt):
    """The kernels' order: the bucket of a residue is its token, or NAA
    where s is 0; thread t walks residues [t S, t S + S) (S = ceil(N / nt)
    rounded up to 4), counts per (bucket, thread) are scanned in (bucket,
    thread) order, and a second walk places each residue. Returns the order
    and the starts of buckets 0 .. NAA (the last is N_live)."""
    N = aa_flat.numel()
    S = ((N + nt - 1) // nt + 3) & ~3
    bkt = torch.where(s_flat != 0, aa_flat.clamp(0, NAA - 1), NAA).tolist()
    cnt = np.zeros((NAA + 1, nt), np.int64)
    for t in range(nt):
        for n in range(t * S, min(N, t * S + S)):
            cnt[bkt[n], t] += 1
    start = np.concatenate([[0], np.cumsum(cnt.reshape(-1))[:-1]]).reshape(NAA + 1, nt)
    order = np.empty(N, np.int64)
    for t in range(nt):
        for n in range(t * S, min(N, t * S + S)):
            order[start[bkt[n], t]] = n
            start[bkt[n], t] += 1
    return order, np.concatenate([[0], np.cumsum(np.bincount(bkt, minlength=NAA + 1))])[:NAA + 1]


def _chunks(N, G):
    return [(N * z // G, N * (z + 1) // G) for z in range(G)]


def _chunk_of(p, N, G):
    return (G * (p + 1) - 1) // N


def _tile(args, p, n, jt, sort, rnd):
    """Rows of residue n's j tile jt: (source j of each row, number of live
    rows, x as the kernel rounds it, w = e m (-d2) sigmoid(coef)); with
    `sort` only the live rows, sorted stably by token."""
    pos, amask, aa, smask = args
    B, L = aa.shape
    b, i = divmod(n, L)
    j0 = jt * TJ
    js = torch.arange(j0, min(L, j0 + TJ))
    live = smask[b, js] != 0
    if sort:   # live rows first, stably by token
        key = torch.where(live, aa[b, js].clamp(0, NAA - 1), torch.full_like(js, NAA))
        perm = torch.sort(key, stable=True).indices
        js, live = js[perm], live[perm]
    nlive = int(live.sum())
    js = js[live] if sort else js
    k = int(aa[b, i].clamp(0, NAA - 1))
    coef = p["table"][k * NAA + aa[b, js].clamp(0, NAA - 1)]
    sp2 = (Fn.softplus(coef) * LOG2E).float()
    d2 = ((pos[b, i][:, None, :] - pos[b, js][:, None, :, :]) ** 2).sum(-1).reshape(len(js), AA2)
    em = torch.exp2(-(sp2 * d2)) * (amask[b, i][:, None] * amask[b, js][:, None, :]).reshape(len(js), AA2)
    if not sort:
        em = em * (smask[b, js] != 0).float()[:, None]
    w = em * (-d2) * torch.sigmoid(coef)
    return js, nlive, rnd(em), w


def dist_fwd_tiled(args, p, sms=132, nt=128, dtype=bf):
    """K3's schedule in plain PyTorch, operands rounded to `dtype` where
    the kernel rounds them to bf16; returns (B, L, L, 64) in `dtype`."""
    pos, amask, aa, smask = args
    B, L = aa.shape
    N = B * L
    G = min(2 * sms, N)
    rnd = lambda t: t.to(dtype).float()
    k1, k2 = rnd(p["k1"]), rnd(p["k2"])
    out = torch.full((B, L, L, NF), float("nan"))
    out[smask == 0] = 0.0
    order, starts = sorted_items(aa.reshape(-1), smask.reshape(-1), nt)
    for p0, p1 in _chunks(int(starts[NAA]), G):
        for n in order[p0:p1].tolist():
            b, i = divmod(n, L)
            for jt in range((L + TJ - 1) // TJ):
                js, _, x, _ = _tile(args, p, n, jt, False, rnd)
                h = rnd(torch.relu(x @ k1 + p["b1"]))
                o = torch.relu(h @ k2 + p["b2"]) * (smask[b, i] * smask[b, js])[:, None]
                out[b, i, js] = o
    return out.to(dtype)


def dist_bwd_tiled(args, p, g, sms=132, nt=256, dtype=bf):
    """K5's schedule in plain PyTorch, operands rounded to `dtype` where
    the kernel rounds them to bf16; returns {name: float32 grad}."""
    pos, amask, aa, smask = args
    B, L = aa.shape
    N = B * L
    G, slots = cuda_dist.bwd_schedule(B, L, sms)
    rnd = lambda t: t.to(dtype).float()
    k1, k2 = rnd(p["k1"]), rnd(p["k2"])
    gg = g.float()
    order, starts = sorted_items(aa.reshape(-1), smask.reshape(-1), nt)
    n_live = int(starts[NAA])
    tpart = torch.full((slots, NAA, AA2), float("nan"))
    wpart = torch.zeros(G, cuda_dist.BWD_PART)
    for z, (p0, p1) in enumerate(_chunks(n_live, G)):
        dk1 = torch.zeros(AA2, NF)
        dk2 = torch.zeros(NF, NF)
        db1 = torch.zeros(NF)
        db2 = torch.zeros(NF)
        cur, slab = -1, None
        for n in order[p0:p1].tolist():
            b, i = divmod(n, L)
            k = int(aa[b, i].clamp(0, NAA - 1))
            if k != cur:
                if cur >= 0:
                    tpart[z + cur] = slab
                cur, slab = k, torch.zeros(NAA, AA2)
            for jt in range((L + TJ - 1) // TJ):
                js, nlive, x, w = _tile(args, p, n, jt, True, rnd)
                if nlive == 0:
                    continue
                a1 = x @ k1 + p["b1"]
                h = rnd(torch.relu(a1))
                a2 = h @ k2 + p["b2"]
                da2 = gg[b, i, js] * (smask[b, i] * smask[b, js])[:, None] * (a2 > 0)
                da1 = (rnd(da2) @ k2.t()) * (a1 > 0)
                dx = rnd(da1) @ k1.t()
                dcoef = dx * w
                toks = aa[b, js].clamp(0, NAA - 1)
                for k2_ in torch.unique_consecutive(toks).tolist():   # runs of equal aa_j, rows in order
                    slab[k2_] += dcoef[toks == k2_].sum(0)
                dk1 += x.t() @ rnd(da1)
                dk2 += h.t() @ rnd(da2)
                db1 += da1.sum(0)
                db2 += da2.sum(0)
        if cur >= 0:
            tpart[z + cur] = slab
        wpart[z] = torch.cat([dk1.reshape(-1), dk2.reshape(-1), db1, db2])
    d_table = torch.zeros(NAA * NAA, AA2)
    chunks = _chunks(n_live, G)
    for k in range(NAA):
        s0, s1 = int(starts[k]), int(starts[k + 1])
        if s1 > s0:   # empty chunks (fewer live residues than blocks) hold no partial
            for z in range(_chunk_of(s0, n_live, G), _chunk_of(s1 - 1, n_live, G) + 1):
                if chunks[z][1] > chunks[z][0]:
                    d_table[k * NAA:(k + 1) * NAA] += tpart[z + k]
    w = torch.zeros(cuda_dist.BWD_PART)
    for z in range(G):
        w += wpart[z]
    o1, o2 = AA2 * NF, AA2 * NF + NF * NF
    return {"table": d_table, "k1": w[:o1].reshape(AA2, NF), "k2": w[o1:o2].reshape(NF, NF),
            "b1": w[o2:o2 + NF], "b2": w[o2 + NF:]}


def _close_in_norm(got, want, rel, tag):
    for name in NAMES:
        a, b = np.asarray(got[name], np.float32), np.asarray(want[name], np.float32)
        assert np.isfinite(a).all(), f"{tag} {name}: non-finite"
        err = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
        assert err <= rel, f"{tag} {name}: {err:.3e} of the norm, beyond {rel}"


def _jax_args(args, p):
    pos, amask, aa, smask = (t.numpy() for t in args)
    aa_pair = jnp.asarray(aa[:, :, None] * NAA + aa[:, None, :], dtype=jnp.int32)
    pmask = jnp.asarray(smask[:, :, None] * smask[:, None, :])
    return (jnp.asarray(pos), jnp.asarray(amask), aa_pair, pmask,
            *(jnp.asarray(p[k].numpy()) for k in NAMES))


def test_sorted_order_chunks_and_slots():
    """The order from thread segments is the stable order by bucket (the
    token, or NAA where s is 0), for any thread count; every cut of the live
    positions into chunks (small grids, so runs cross chunk edges; more
    blocks than live residues) has the reduction's inverse chunk_of, and the
    slots z + k of the runs of different blocks never collide."""
    rng = np.random.default_rng(3)
    for N in (1, 7, 37, 300, 2048):
        aa = torch.from_numpy(rng.integers(0, NAA, size=N))
        s = torch.from_numpy((rng.random(N) > 0.25).astype(np.float32))
        bkt = np.where(s.numpy() != 0, aa.numpy(), NAA)
        want = np.argsort(bkt, kind="stable")
        for nt in (128, 256):
            order, starts = sorted_items(aa, s, nt)
            assert np.array_equal(order, want), (N, nt)
            assert np.array_equal(starts[1:] - starts[:-1], np.bincount(bkt, minlength=NAA + 1)[:NAA])
        n_live = int(starts[NAA])
        for G in sorted({1, min(4, N), min(16, N), min(132, N)}):
            seen = set()
            for z, (p0, p1) in enumerate(_chunks(n_live, G)):
                for pp in range(p0, p1):
                    assert _chunk_of(pp, n_live, G) == z
                for k in set(bkt[want[p0:p1]].tolist()):
                    assert k < NAA and z + k not in seen
                    seen.add(z + k)
            assert max(seen, default=0) < G + NAA - 1


# (B, L, sms, one_token): chunks of a few residues with runs crossing their
# edges and a ragged tile; two j tiles at L > 64; one token in every batch
# row, so one run crosses every chunk.
@pytest.mark.parametrize("B,L,sms,one_token", [(3, 37, 4, False), (2, 100, 16, False),
                                              (2, 40, 4, True)])
def test_backward_schedule_matches_plain(B, L, sms, one_token):
    args, p, g = _inputs(B, L, seed=B * 100 + L, one_token=one_token)
    got = dist_bwd_tiled(args, p, g, sms=sms)
    want = cuda_dist.distance_embed_bwd_plain(*args, p, g, torch.bfloat16)
    _close_in_norm(got, want, 2e-3, f"B={B} L={L}")


def test_backward_schedule_matches_jax_kernel():
    """At (B, L) = (2, 16), (3, 37) and (1, 1) the emulated backward in
    float32 agrees with the Pallas backward kernel in float32, interpret
    mode, as tests/test_torch_grad.py holds the plain version to it. At (2,
    16) on 132 SMs there are more blocks than live residues, so some chunks
    are empty."""
    for B, L, sms in ((2, 16, 132), (3, 37, 4), (1, 1, 4)):
        args, p, g = _inputs(B, L, seed=7 + L)
        got = dist_bwd_tiled(args, p, g, sms=sms, dtype=torch.float32)
        outs = jax_dist_bwd(*_jax_args(args, p), jnp.asarray(g.float().numpy()),
                            dtype=jnp.float32, interpret=True)
        for name, want in zip(NAMES, outs):
            np.testing.assert_allclose(got[name].numpy(), np.asarray(want), rtol=1e-3, atol=1e-4,
                                       err_msg=f"vs JAX B={B} L={L} {name}")


def test_forward_schedule_matches_plain_and_jax():
    """The emulated forward in bf16 against the plain version at (2, 16),
    (3, 37), (1, 1), a one-token batch and L = 100 (two j tiles); in float32
    against the JAX kernel in float32, interpret mode, at the first three, as
    tests/test_torch_dist.py holds the plain version to it."""
    for B, L, sms, one, jax_too in ((2, 16, 4, False, True), (3, 37, 4, False, True),
                                    (1, 1, 4, False, True), (2, 40, 2, True, False),
                                    (1, 100, 8, False, False)):
        args, p, _ = _inputs(B, L, seed=50 + L, one_token=one)
        got = dist_fwd_tiled(args, p, sms=sms).float()
        want = cuda_dist.distance_embed_plain(*args, p, torch.bfloat16).float()
        assert torch.isfinite(got).all()
        err = float((got - want).abs().max())
        assert err <= 2e-2, f"B={B} L={L}: {err:.3e} from the plain version"
        if jax_too:
            got = dist_fwd_tiled(args, p, sms=sms, dtype=torch.float32)
            ref = jax_dist_fwd(*_jax_args(args, p), dtype=jnp.float32, interpret=True)
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4,
                                       err_msg=f"vs JAX B={B} L={L}")


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


def _k_major(img, start, k, n):
    """Element (k, n) of a K-major operand read through desc_sw128(start): row
    n 128 bytes on, K columns two bytes apart inside it, 8-row groups 1024
    bytes apart; start may sit 32 s bytes into the rows (depth step s)."""
    addr = start + (n % 8) * 128 + (n // 8) * 1024 + 2 * k
    return img[_swizzle(addr) // 2]


def test_operand_maps():
    """(1) K1 [240][64] staged in swizzled rows is B[k][n] = K1[16s + k][n] of
    a1 = x.K1 read MN-major from 2048 s, and B[k][n] = K1[120 wg + n][16s + k]
    (= K1^T) of dx's half wg read K-major from 120 wg rows + 32 s bytes. (2)
    The x panel (rows: pairs; four 64-column panels) read MN-major from panel
    m + 2048 s is x^T[64 m + mm][16 s + k] (A of dK1, block m), and K-major
    from panel s / 4 + 32 (s % 4) is x[r][16 s + k] (A of a1); a da1 panel
    read MN-major is da1[16 s + k][n]. (3) A thread's pair (row 16 warp + g,
    columns 8 jb + 2q, + 1) written at pair_offset lands where the panel
    holds it, row + 8 1024 bytes on; build_x's four columns 4 c4 .. 4 c4 + 3
    of a row, 8 bytes at panel c4 / 16, chunk (c4 % 16) / 2 ^ (r % 8), half
    c4 % 2, fill the x panel's K-major image."""
    rng = np.random.default_rng(0)
    K1 = rng.integers(0, 1 << 15, size=(KP, NF)).astype(np.int64)
    img = _kmajor_image(K1)
    for s in range(KP // 16):
        for k in range(16):
            for nn in range(0, NF, 7):
                assert _mn_major(img, s * 2048, 8192, k, nn) == K1[16 * s + k, nn]
    for wg in range(2):
        for s in range(NF // 16):
            for k in range(16):
                for nn in range(0, 120, 7):
                    assert _k_major(img, wg * 120 * 128 + 32 * s, k, nn) == K1[120 * wg + nn, 16 * s + k]

    X = rng.integers(0, 1 << 15, size=(TJ, 256)).astype(np.int64)
    ximg = _kmajor_image(X)
    built = np.zeros_like(ximg)
    for r in range(TJ):
        for c4 in range(64):
            byte = (c4 // 16) * 8192 + r * 128 + ((((c4 % 16) // 2) ^ (r % 8)) << 4) + (c4 % 2) * 8
            built[byte // 2:byte // 2 + 4] = X[r, 4 * c4:4 * c4 + 4]
    assert np.array_equal(built, ximg)
    for s in range(TJ // 16):
        for k in range(16):
            for m in range(4):
                for mm in range(0, 64, 5):
                    assert _mn_major(ximg, m * 8192 + s * 2048, 8192, k, mm) == X[16 * s + k, 64 * m + mm]
    for s in range(KP // 16):
        for k in range(16):
            for r in range(0, TJ, 3):
                assert _k_major(ximg, (s // 4) * 8192 + (s % 4) * 32, k, r) == X[r, 16 * s + k]

    D = rng.integers(0, 1 << 15, size=(TJ, NF)).astype(np.int64)
    dimg = np.zeros(TJ * 64, np.int64)
    for warp in range(4):
        for lane in range(32):
            g, q = divmod(lane, 4)
            ra = 16 * warp + g
            for jb in range(8):
                off = ra * 128 + ((jb ^ g) << 4) + 4 * q
                for row, o in ((ra, off), (ra + 8, off + 1024)):
                    dimg[o // 2:o // 2 + 2] = D[row, 8 * jb + 2 * q:8 * jb + 2 * q + 2]
    assert np.array_equal(dimg, _kmajor_image(D))
    for s in range(TJ // 16):
        for k in range(16):
            for nn in range(0, NF, 3):
                assert _mn_major(dimg, s * 2048, 8192, k, nn) == D[16 * s + k, nn]
