"""The schedule of the v1 IPA attention core's tensor-core kernel (K9,
``csrc/ipa1.cu``, bf16 inputs at the model's widths), emulated in plain
PyTorch on the CPU, against ``cuda_ipa1.ipa_attention_plain`` and the JAX
package's ``fused_ipa_attention`` and ``fused_ipa_attention_bh`` (Pallas,
interpret mode).

The CUDA kernel cannot run here, so :func:`ipa1_tiled` repeats what it does
and in which order (K7's attention core, ``ipa2_tile.cuh``, without the
frames): 64 query rows a block, keys in tiles of 64; the logits of a tile
(q·k of the bf16 values in fp32, the point term through the square
expansion of the fp32 global points, bias, mask; -inf past the ragged
edge); for L <= 64 the row's max and sum from the one tile, for L > 64 a
first pass over the key tiles for them (the running max and sum of exp, as
``row_update`` keeps them); the weights a = exp(s - m) · (1/l) in fp32; o
summed over key tiles from bf16(a) in fp32; o_pt and o_pair in 8-key chunks
from the fp32 a. The kernel reads K7's fragment and swizzle maps
(tests/test_torch_ipa2_tiles.py checks them); a further test checks the
maps that K9's layouts give them: the pair ring's items under the strides
of a contiguous (B, L, L, CZ4) pz, the value points' halves, the bias tile.

Tolerances. Against ``ipa_attention_plain`` (the same rounding points, sums
in another order): 2e-3 + 1e-3 |plain|. The only gap beyond fp32 noise is a
weight that rounds to the other bf16 neighbour in one of the two, which
moves o by one bf16 step of that weight times |v|; that fits inside the
card's check ``IPA_TOL`` (2e-2 + 1e-3 |plain|, ``chip_smoke.py``). Against
the JAX kernels in interpret mode, both fed the same numpy-made inputs: the
same, at L = 24 and 64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pepflowww_tpu.models import pallas_ipa as P

from pepflowww_torch.models import cuda_ipa1

torch.set_num_threads(1)
TQ, CHUNK, NTH = 64, 8, 128   # rows of a query / key tile, keys of a pair chunk, threads
H, C, PQ, PV, CZ4 = 2, 128, 8, 12, 16
TOL = (2e-3, 1e-3)


def _inputs(B, L, seed, masked_tile=False):
    """Head-major inputs, numpy-made: q, k, v, bias and pair_z in bf16,
    global points fp32, ~15% of the keys masked, and with `masked_tile`
    every key of the second key tile."""
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    bf = torch.bfloat16
    mask = rng.uniform(size=(B, L)) > 0.15
    mask[:, 0] = True
    if masked_tile:
        mask[:, TQ:2 * TQ] = False
    return [f(B, H, L, C).to(bf), f(B, H, L, C).to(bf), f(B, H, L, C).to(bf),
            f(B, H, L, 3 * PQ), f(B, H, L, 3 * PQ), f(B, H, L, 3 * PV), f(B, H, L, L).to(bf),
            f(B, L, L, CZ4).to(bf), torch.from_numpy(mask.astype(np.float32))]


def ipa1_tiled(q, k, v, q_pts, k_pts, v_pts, bias, pair_z, mask, inf=1e5):
    """The kernel's schedule in plain PyTorch (see the module docstring).
    Returns (o, o_pt, o_pair), float32, head-major."""
    B, Hh, L, Cc = q.shape
    f = lambda x: x.float()
    s1, s2 = 1.0 / (3 * Cc) ** 0.5, 1.0 / 3.0 ** 0.5
    qf, kf, vf, qp, kp, vp, pz = (f(x) for x in (q, k, v, q_pts, k_pts, v_pts, pair_z))
    mb = inf * (f(mask) - 1.0)                                       # (B, L)
    o = torch.zeros(B, Hh, L, Cc)
    opt = torch.zeros(B, Hh, L, vp.shape[-1])
    opair = torch.zeros(B, Hh, L, pz.shape[-1])
    tiles = [(j0, min(TQ, L - j0)) for j0 in range(0, L, TQ)]
    for i0 in range(0, L, TQ):
        nq = min(TQ, L - i0)
        qi, qpi = qf[:, :, i0:i0 + nq], qp[:, :, i0:i0 + nq]
        qsq = qpi.square().sum(-1, keepdim=True)

        def logits(j0, nk):   # (B, H, nq, 64), -inf past the edge
            s = torch.full((B, Hh, nq, TQ), float("-inf"))
            kpj = kp[:, :, j0:j0 + nk]
            pt = qpi @ kpj.transpose(-1, -2)
            ksq = kpj.square().sum(-1)[:, :, None, :]
            s[..., :nk] = (qi @ kf[:, :, j0:j0 + nk].transpose(-1, -2) * s1
                           + f(bias[:, :, i0:i0 + nq, j0:j0 + nk]) * s2
                           - 0.5 * (qsq + ksq - 2.0 * pt) + mb[:, None, None, j0:j0 + nk])
            return s

        if len(tiles) == 1:
            s = logits(0, L)
            m = s.max(-1, keepdim=True).values
            e = torch.exp(s - m)
            inv = 1.0 / e.sum(-1, keepdim=True)
        else:   # pass 1: the running max and sum of exp over the key tiles, logits alone
            m = torch.full((B, Hh, nq, 1), float("-inf"))
            lsum = torch.zeros(B, Hh, nq, 1)
            for j0, nk in tiles:
                s = logits(j0, nk)
                mn = torch.maximum(m, s.max(-1, keepdim=True).values)
                lsum = torch.where(m == float("-inf"), 0.0, lsum * torch.exp(m - mn)) \
                    + torch.exp(s - mn).sum(-1, keepdim=True)
                m = mn
            inv = 1.0 / lsum
        for j0, nk in tiles:   # pass 2 (the only pass for L <= 64)
            a = (e if len(tiles) == 1 else torch.exp(logits(j0, nk) - m)) * inv
            a = a[..., :nk]
            o[:, :, i0:i0 + nq] += a.bfloat16().float() @ vf[:, :, j0:j0 + nk]
            for c0 in range(0, nk, CHUNK):
                ac = a[..., c0:c0 + CHUNK]
                jj = slice(j0 + c0, j0 + min(c0 + CHUNK, nk))
                opt[:, :, i0:i0 + nq] += ac @ vp[:, :, jj]
                opair[:, :, i0:i0 + nq] += torch.einsum("bhij,bijd->bhid", ac,
                                                        pz[:, i0:i0 + nq, jj])
    return o, opt, opair


def _close(got, want, name):
    atol, rtol = TOL
    for n, a, b in zip(("o", "o_pt", "o_pair"), got, want):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        assert np.isfinite(a).all(), f"{name} {n}: non-finite"
        excess = float((np.abs(a - b) - rtol * np.abs(b)).max())
        assert excess <= atol, f"{name} {n}: {excess:.3e} beyond {atol}"


@pytest.mark.parametrize("L", [1, 24, 64, 100, 256])
def test_tiled_schedule_matches_plain(L):
    """One key tile (L <= 64) or several, ragged edges, and at L = 256 a key
    tile whose every key is masked; at L = 24 and 64 also both JAX grid
    variants (each L compiles them anew in interpret mode, a few seconds)."""
    B = 1 if L == 256 else 2
    args = _inputs(B, L, seed=L, masked_tile=L > 2 * TQ)
    got = ipa1_tiled(*args)
    _close(got, cuda_ipa1.ipa_attention_plain(*args), f"L={L} vs plain")
    if L in (24, TQ):
        jargs = [jnp.asarray(x.float().numpy()).astype(
            jnp.bfloat16 if x.dtype == torch.bfloat16 else jnp.float32) for x in args]
        for fn in (P.fused_ipa_attention, P.fused_ipa_attention_bh):
            kern = jax.jit(lambda *a: fn(*a, interpret=True))(*jargs)
            _close(got, [np.asarray(x) for x in kern], f"L={L} vs JAX {fn.__name__}")


def test_layout_maps():
    """The maps of K9's layouts in the kernel's index arithmetic, at a
    ragged L over two query and key tiles. (1) The pair ring: with pz (B, L,
    L, CZ4) contiguous, strides stz = (L·L·CZ4, L·CZ4, CZ4, 1) (ipa1.cu), item
    u of thread (ar, ah) in chunk kc of key tile j0 (copy_pair, PZ_D) holds
    channels 8ah..8ah+7 of key j0 + 8kc + u of row i0 + ar, which consume
    weighs with a[ar, 8kc + u]; zero past nq or nk. (2) The value points
    (store_value_points): columns 0..17 at floats 0..17, 18..35 at 20..37 of
    a row, so half ah's 18 sums (consume: 4 float4 and a float2 from 20ah)
    are columns 18ah..18ah+17, which outputs writes there. (3) The bias tile
    (copy_keys, L % 8 == 0): thread idx copies keys 8c..8c+7 (c = idx % 8)
    of row idx / 8 to element 8c of that row, so logit_terms reads key c0 of
    row r at r·LDB + c0."""
    B, L = 2, 100
    pz = np.arange(B * L * L * CZ4).reshape(B, L, L, CZ4)
    flat = pz.ravel()
    stz = (L * L * CZ4, L * CZ4, CZ4, 1)
    for b in range(B):
        for i0 in range(0, L, TQ):
            nq = min(TQ, L - i0)
            for tid in range(NTH):
                ar, ah = tid >> 1, tid & 1
                pz_row = b * stz[0] + (i0 + (ar if ar < nq else 0)) * stz[1]
                for j0 in range(0, L, TQ):
                    nk = min(TQ, L - j0)
                    for kc in range(TQ // CHUNK):
                        if CHUNK * kc >= nk:
                            continue
                        for u in range(8):
                            valid = ar < nq and CHUNK * kc + u < nk
                            src = pz_row + (j0 + CHUNK * kc + u) * stz[2] + 8 * ah
                            item = flat[src:src + 8] if valid else np.zeros(8, int)
                            want = (pz[b, i0 + ar, j0 + CHUNK * kc + u, 8 * ah:8 * ah + 8]
                                    if valid else np.zeros(8, int))
                            assert (item == want).all(), (b, i0, tid, j0, kc, u)

    LDV = 40
    vg = np.arange(3 * PV)
    row = np.full(LDV, -1)
    for u in range(9):
        row[2 * u:2 * u + 2] = vg[2 * u:2 * u + 2]
        row[20 + 2 * u:22 + 2 * u] = vg[18 + 2 * u:20 + 2 * u]
    for ah in range(2):
        assert (row[20 * ah:20 * ah + 18] == vg[18 * ah:18 * ah + 18]).all()

    LDB, L = TQ + 8, 128
    bias = np.arange(L * L).reshape(L, L)
    for i0 in range(0, L, TQ):
        for j0 in range(0, L, TQ):
            tile = np.full((TQ, LDB), -1)
            for tid in range(NTH):
                for k in range(4):
                    idx = tid + NTH * k
                    r, c = idx >> 3, idx & 7
                    tile[r, 8 * c:8 * c + 8] = bias[i0 + r, j0 + 8 * c:j0 + 8 * c + 8]
            assert (tile[:, :TQ] == bias[i0:i0 + TQ, j0:j0 + TQ]).all()
