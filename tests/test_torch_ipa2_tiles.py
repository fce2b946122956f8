"""The schedule of the fused IPA forward kernel (K7, ``csrc/ipa2.cu``),
emulated in plain PyTorch on the CPU, against ``cuda_ipa.ipa2_plain`` and
the JAX package's ``fused_ipa2`` (Pallas, interpret mode).

The CUDA kernel cannot run here, so :func:`ipa2_tiled` repeats what it does
and in which order: 64 query rows a block, keys in tiles of 64; the logits of
a tile (q·k of the bf16 values in fp32, the point term through the square
expansion, bias, mask; -inf past the ragged edge); for L <= 64 the row's max
and sum from the one tile, for L > 64 a first pass over the key tiles for
them (the running max and sum of exp, as ``row_update`` keeps them); the
weights a = exp(s - m) · (1/l) in fp32; o summed over key tiles from bf16(a)
in fp32; the point and pair sums in 8-key chunks from the fp32 a. A further
test checks the index maps that the kernel relies on: the wgmma accumulator
of the logits read as the A operand of o's product, and V's MN-major
swizzled panels read through its descriptor.

Tolerances. Against ``ipa2_plain`` (the same rounding points, sums in
another order): 2e-3 + 1e-3 |plain|. The only gap beyond fp32 noise is a
weight that rounds to the other bf16 neighbour in one of the two, which
moves o by one bf16 step of that weight times |v| (< 4e-3 with these
inputs, a single weight above 1/2); that fits inside the card's check
``IPA_TOL`` (2e-2 + 1e-3 |plain|, ``chip_smoke.py``). Against the JAX kernel
in interpret mode: the same, at L = 24 and 64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pepflowww_tpu.models import pallas_ipa2 as P

from pepflowww_torch.models import cuda_ipa

torch.set_num_threads(1)
TQ, CHUNK = 64, 8           # rows of a query / key tile, keys of a pair chunk (csrc/ipa2.cu)
H, C, PQ, PV, CZ4 = 2, 128, 8, 12, 16
TOL = (2e-3, 1e-3)


def _rotmats(v):
    """Rotation matrices of rotation vectors `v` (..., 3), Rodrigues'
    formula, float32."""
    th = np.linalg.norm(v, axis=-1)[..., None, None]
    k = v / np.linalg.norm(v, axis=-1, keepdims=True)
    K = np.zeros(v.shape + (3,))
    K[..., 0, 1], K[..., 0, 2], K[..., 1, 2] = -k[..., 2], k[..., 1], -k[..., 0]
    K = K - np.swapaxes(K, -1, -2)
    return (np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K).astype(np.float32)


def _inputs(B, L, seed, masked_tile=False):
    """Module-layout inputs (points as permuted views, the sampler's pair
    readout as a view of (B, CZ4, L, L)) in bf16 where the model feeds bf16,
    as numpy-made torch tensors; ~15% of the keys masked, and with
    `masked_tile` every key of the second key tile."""
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: torch.from_numpy((rng.normal(size=s) * sc).astype(np.float32))
    bf = torch.bfloat16
    R = torch.from_numpy(_rotmats(rng.normal(size=(B, L, 3))).reshape(B, L, 9))
    mask = rng.uniform(size=(B, L)) > 0.15
    mask[:, 0] = True
    if masked_tile:
        mask[:, TQ:2 * TQ] = False
    maskb = torch.from_numpy((1e5 * (mask.astype(np.float32) - 1.0))[:, None, :])
    qp = f(B, L, 3, H, PQ, sc=2.0).to(bf).permute(0, 3, 2, 1, 4)
    kvp = f(B, L, 3, H, PQ + PV, sc=2.0).to(bf).permute(0, 3, 2, 1, 4)
    bias = f(B, H, L, L).to(bf)
    pz = f(B, CZ4, L, L).to(bf).permute(0, 2, 3, 1)
    sw = f(1, H, sc=0.1).abs() + 0.2
    return [f(B, L, H * C).to(bf), f(B, L, 2 * H * C).to(bf), qp, kvp, R, f(B, L, 3, sc=5.0),
            bias, pz, maskb, sw]


def ipa2_tiled(q, kv, qp, kvp, r9, t, bias, pz, maskb, sw, eps=1e-8):
    """K7's schedule in plain PyTorch (see the module docstring). Returns
    (o, optl, norm, opair) in the kernel's output layouts, float32."""
    B, L = q.shape[:2]
    f = lambda x: x.float()
    R = f(r9).reshape(B, L, 3, 3)
    tt = f(t)
    s1, s2 = 1.0 / (3 * C) ** 0.5, 1.0 / 3.0 ** 0.5

    def glob(x, scale):   # (B, H, 3, L, P) -> (B, H, L, 3 * P): (sum_d R[c, d] x_d + t_c) * scale
        x = f(x)
        cs = [(R[:, None, :, c, 0, None] * x[:, :, 0] + R[:, None, :, c, 1, None] * x[:, :, 1]
               + R[:, None, :, c, 2, None] * x[:, :, 2] + tt[:, None, :, c, None]) * scale
              for c in range(3)]
        return torch.cat(cs, -1)

    swb = f(sw).reshape(1, H, 1, 1)
    qg, kg = glob(qp, swb), glob(kvp[..., :PQ], swb)
    vg = glob(kvp[..., PQ:], 1.0)                                    # (B, H, L, 36)
    qh = f(q).reshape(B, L, H, C).transpose(1, 2)
    kvh = f(kv).reshape(B, L, H, 2 * C).transpose(1, 2)
    kh, vh = kvh[..., :C], kvh[..., C:]
    pzf = f(pz)
    mb = f(maskb)[:, 0]                                              # (B, L)
    o = torch.zeros(B, H, L, C)
    pts = torch.zeros(B, H, L, 3 * PV)
    opair = torch.zeros(B, H, L, CZ4)
    tiles = [(j0, min(TQ, L - j0)) for j0 in range(0, L, TQ)]
    for i0 in range(0, L, TQ):
        nq = min(TQ, L - i0)
        qi, qgi = qh[:, :, i0:i0 + nq], qg[:, :, i0:i0 + nq]
        qsq = qgi.square().sum(-1, keepdim=True)

        def logits(j0, nk):   # (B, H, nq, 64), -inf past the edge
            s = torch.full((B, H, nq, TQ), float("-inf"))
            kgj = kg[:, :, j0:j0 + nk]
            pt = qgi @ kgj.transpose(-1, -2)
            ksq = kgj.square().sum(-1)[:, :, None, :]
            s[..., :nk] = (qi @ kh[:, :, j0:j0 + nk].transpose(-1, -2) * s1
                           + f(bias[:, :, i0:i0 + nq, j0:j0 + nk]) * s2
                           - 0.5 * (qsq + ksq - 2.0 * pt) + mb[:, None, None, j0:j0 + nk])
            return s

        if len(tiles) == 1:
            s = logits(0, L)
            m = s.max(-1, keepdim=True).values
            e = torch.exp(s - m)
            inv = 1.0 / e.sum(-1, keepdim=True)
        else:   # pass 1: the running max and sum of exp over the key tiles
            m = torch.full((B, H, nq, 1), float("-inf"))
            lsum = torch.zeros(B, H, nq, 1)
            for j0, nk in tiles:
                s = logits(j0, nk)
                mn = torch.maximum(m, s.max(-1, keepdim=True).values)
                lsum = torch.where(m == float("-inf"), 0.0, lsum * torch.exp(m - mn)) \
                    + torch.exp(s - mn).sum(-1, keepdim=True)
                m = mn
            inv = 1.0 / lsum
        for j0, nk in tiles:   # pass 2
            a = (e if len(tiles) == 1 else torch.exp(logits(j0, nk) - m)) * inv
            a = a[..., :nk]
            o[:, :, i0:i0 + nq] += a.bfloat16().float() @ vh[:, :, j0:j0 + nk]
            for c0 in range(0, nk, CHUNK):
                ac = a[..., c0:c0 + CHUNK]
                jj = slice(j0 + c0, j0 + min(c0 + CHUNK, nk))
                pts[:, :, i0:i0 + nq] += ac @ vg[:, :, jj]
                opair[:, :, i0:i0 + nq] += torch.einsum(
                    "bhij,bijd->bhid", ac, pzf[:, i0:i0 + nq, jj])
    d = pts.reshape(B, H, L, 3, PV) - tt[:, None, :, :, None]
    loc = torch.einsum("blcd,bhlcp->bhldp", R, d)                     # R^T (o - t)
    norm = torch.sqrt(loc.square().sum(3) + eps)                      # (B, H, L, PV)
    return (o.transpose(1, 2).reshape(B, L, H * C),
            loc.permute(0, 2, 3, 1, 4).reshape(B, L, 3 * H * PV),
            norm.transpose(1, 2).reshape(B, L, H * PV),
            opair.transpose(1, 2).reshape(B, L, H * CZ4))


def _close(got, want, name):
    atol, rtol = TOL
    for n, a, b in zip(("o", "optl", "norm", "opair"), got, want):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        assert np.isfinite(a).all(), f"{name} {n}: non-finite"
        excess = float((np.abs(a - b) - rtol * np.abs(b)).max())
        assert excess <= atol, f"{name} {n}: {excess:.3e} beyond {atol}"


@pytest.mark.parametrize("L", [1, 24, 40, 64, 100, 256])
def test_tiled_schedule_matches_plain(L):
    """One (L <= 64) or several key tiles, ragged edges, and for L > 64 a key
    tile whose every key is masked; at the nb=6 oracle's L=24 and the
    sampler's L=64 also the JAX kernel (each L compiles it anew in interpret
    mode, a few seconds)."""
    B = 1 if L == 256 else 2
    args = _inputs(B, L, seed=L, masked_tile=L > 2 * TQ)
    got = ipa2_tiled(*args)
    _close(got, cuda_ipa.ipa2_plain(*args), f"L={L} vs plain")
    if L in (24, TQ):
        jargs = [jnp.asarray(x.float().contiguous().numpy()).astype(
            jnp.bfloat16 if x.dtype == torch.bfloat16 else jnp.float32) for x in args]
        kern = jax.jit(lambda *a: P.fused_ipa2(*a, interpret=True))(*jargs)
        _close(got, [np.asarray(k) for k in kern], f"L={L} vs JAX")


def test_fragment_and_swizzle_maps():
    """The index maps of o's product. (1) The logits' m64n64 fp32
    accumulator, packed as ha[k] = bf16 pair (s[2k], s[2k + 1]), is the bf16
    A operand of depth step st in ha[4st .. 4st + 3] (wgmma.cuh's layouts).
    (2) V, copied as rows j with channel chunk c at sw128_offset(j, c % 8)
    of panel c // 8, is read at B[k][n] = V[16 st + k][64 p + n] through the
    MN-major 128-byte-swizzle descriptor of step st, panel p: start panel +
    2048 st, 8-row groups 1024 bytes apart (CUTLASS's canonical layout
    Sw<3,4,3> o ((8,8,m),(8,k)) : ((1,8,LBO),(64,SBO)) in elements, m = 1)."""
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
                        row, col = acc_pos(w, g, q, 2 * (4 * st + reg) + half)
                        frow, fcol = afrag_pos(w, g, q, reg, half)
                        assert (row, col) == (frow, 16 * st + fcol)

    rng = np.random.default_rng(0)
    V = rng.integers(0, 1 << 15, size=(TQ, C)).astype(np.int64)
    panel = TQ * 128
    smem = np.zeros(2 * panel // 2, np.int64)    # bf16 elements of V's two panels
    for j in range(TQ):
        for c in range(C // 8):
            byte = (c // 8) * panel + j * 128 + (((c % 8) ^ (j % 8)) << 4)
            smem[byte // 2:byte // 2 + 8] = V[j, 8 * c:8 * c + 8]
    sbo = 1024   # the leading byte offset (between 64-column blocks) is unused at N = 64
    for p in range(2):
        for st in range(TQ // 16):
            start = p * panel + st * 2048
            for k in range(16):
                for n in range(64):
                    off = 2 * n + 128 * (k % 8) + sbo * (k // 8)
                    addr = start + off
                    addr ^= ((addr >> 7) & 7) << 4          # Swizzle<3,4,3> on byte addresses
                    assert smem[addr // 2] == V[16 * st + k, 64 * p + n]
