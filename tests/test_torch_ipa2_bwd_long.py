"""The schedule of the fused IPA backward's three kernels for L > 64 (K8,
``csrc/ipa2_bwd.cu``), emulated in plain PyTorch on the CPU, against
``cuda_ipa.ipa2_bwd_plain`` and the JAX package's ``fused_ipa2_bwd``
(Pallas, interpret mode).

The CUDA kernels cannot run here, so :func:`three_kernels` repeats what
they do and in which order, in the training step's input layouts, over
64-row tiles (the last one ragged):

- the query kernel per 64 query rows: sweep 1 over the key tiles keeps each
  row's running max m and sum of exp l online and sums p·vg and
  Σ_j p (bf16(go)·v_j + gopair·pz_ij) with p = exp(s - m), each rescaled by
  exp(m_old - m_new) as m grows, then divided by l: optg and D'; then goptg,
  the inverse transform's d R, d t and D = D' + goptg·optg (the identity
  Σ_j a goptg·vg_j = goptg·optg), saved with m and 1/l as the rows'
  statistics; sweep 2 takes a = exp(s - m) · (1/l) from them and forms g_a,
  gs, gbias, gq = Σ_tiles bf16(gs)·k (in order) and gqg from the row sums;
- the key kernel per 64 key rows: a and gs again from the saved statistics
  and goptg, gk, gv, gvg, gkg and the column sums over the query tiles in
  order;
- the pair kernel: gpz = Σ_h a_h gopair_h over heads in order 0 .. H-1 with
  a from the saved statistics, then gr9, gt (for each head the query side,
  then the key side) and gsw (the query blocks' partials, then the key
  blocks').

Tolerances as in tests/test_torch_ipa2_bwd_tiles.py (norm-relative: gq and
gkv 5e-3, where a bf16 rounding of gs or a may flip against the plain
version; every fp32 gradient 1e-4).
"""

import jax
import jax.numpy as jnp
import pytest
import torch

from pepflowww_tpu.models import pallas_ipa2 as P

from pepflowww_torch.models import cuda_ipa
from test_torch_ipa2_bwd_tiles import C, CZ4, H, INF, PQ, PV, TQ, _close, _Geo, _inputs

torch.set_num_threads(1)


def three_kernels(args, cots):
    """The query, key and pair kernels' schedule (L > 64). Returns the nine
    gradients of ``ipa2_bwd`` in its output layouts, float32."""
    G = _Geo(args, cots)
    B, L = G.B, G.L
    assert L > TQ
    tiles = [slice(r, min(L, r + TQ)) for r in range(0, L, TQ)]
    sw5 = G.sw.reshape(1, H, 1, 1, 1)
    STAT = torch.zeros(B, H, L, 3)                 # m, 1/l, D of each query row
    GOPTG = torch.zeros(B, H, L, 3 * PV)
    GRQ, GRK = torch.zeros(B, H, L, 12), torch.zeros(B, H, L, 12)
    gq = torch.zeros(B, H, L, C)
    gbias = torch.zeros(B, H, L, L)
    gqp = torch.zeros(B, H, 3, L, PQ)
    gswq, gswk = [], []

    def weights(i, j):
        m, inv = STAT[:, :, i, 0:1], STAT[:, :, i, 1:2]
        return torch.exp(G.logits(i, j) - m) * inv

    def grad_a(i, j, goptg):
        return (G.go[:, :, i] @ G.v[:, :, j].transpose(-1, -2)
                + goptg @ G.vg[:, :, j].transpose(-1, -2) + G.pair_term(i, j))

    for i in tiles:                                # the query kernel
        n = i.stop - i.start
        m, lsum = torch.full((B, H, n, 1), -INF), torch.zeros(B, H, n, 1)
        optg, d1 = 0.0, 0.0
        for j in tiles:                            # sweep 1, online: m, l, p.vg, D's parts
            s = G.logits(i, j)
            mn = torch.maximum(m, s.max(-1, keepdim=True).values)
            alpha = torch.where(m == -INF, 0.0, torch.exp(m - mn))
            p = torch.exp(s - mn)
            lsum = lsum * alpha + p.sum(-1, keepdim=True)
            optg = optg * alpha + p @ G.vg[:, :, j]
            g1 = G.go[:, :, i] @ G.v[:, :, j].transpose(-1, -2) + G.pair_term(i, j)
            d1 = d1 * alpha + (p * g1).sum(-1, keepdim=True)
            m = mn
        STAT[:, :, i, 0:1], STAT[:, :, i, 1:2] = m, 1.0 / lsum
        optg, d1 = optg / lsum, d1 / lsum
        goptg, row_inv = G.goptg(optg, i)
        GOPTG[:, :, i] = goptg
        STAT[:, :, i, 2:3] = d1 + (goptg * optg).sum(-1, keepdim=True)
        acc, rs = 0.0, 0.0
        for j in tiles:                            # sweep 2: gs, gbias, gq, gs.kg, the row sums
            gs = weights(i, j) * (grad_a(i, j, goptg) - STAT[:, :, i, 2:3])
            gbias[:, :, i, j] = gs * G.s2
            gq[:, :, i] += gs.bfloat16().float() @ G.k[:, :, j]
            acc = acc + gs @ G.kg[:, :, j]
            rs = rs + gs.sum(-1, keepdim=True)
        gqg = -rs * G.qg[:, :, i] + acc
        gswq.append((gqg * G.qg[:, :, i]).sum((2, 3)))
        gqp[:, :, :, i], rq = G.frame_bwd(0, gqg, i, sw5)
        GRQ[:, :, i] = row_inv + rq

    gk, gv = torch.zeros(B, H, L, C), torch.zeros(B, H, L, C)
    gkp, gvp = torch.zeros(B, H, 3, L, PQ), torch.zeros(B, H, 3, L, PV)
    for j in tiles:                                # the key kernel
        acc, gvg, cs = 0.0, 0.0, 0.0
        for i in tiles:
            a = weights(i, j)
            gs = a * (grad_a(i, j, GOPTG[:, :, i]) - STAT[:, :, i, 2:3])
            a_t, gs_t = a.transpose(-1, -2), gs.transpose(-1, -2)
            gk[:, :, j] += gs_t.bfloat16().float() @ G.q[:, :, i]
            gv[:, :, j] += a_t.bfloat16().float() @ G.go[:, :, i]
            gvg = gvg + a_t @ GOPTG[:, :, i]
            acc = acc + gs_t @ G.qg[:, :, i]
            cs = cs + gs_t.sum(-1, keepdim=True)
        gkg = -cs * G.kg[:, :, j] + acc
        gswk.append((gkg * G.kg[:, :, j]).sum((2, 3)))
        gkp[:, :, :, j], rk = G.frame_bwd(1, gkg, j, sw5)
        gvp[:, :, :, j], rv = G.frame_bwd(2, gvg, j, 1.0)
        GRK[:, :, j] = rk + rv

    rows = slice(0, L)                             # the pair kernel
    gpz, gr = torch.zeros(B, L, L, CZ4), torch.zeros(B, L, 12)
    for hh in range(H):
        a = weights(rows, rows)[:, hh]
        gpz += a[..., None] * G.gopair[:, hh, :, None, :]
        gr += GRQ[:, hh]
        gr += GRK[:, hh]
    gsw = 0.0
    for x in gswq + gswk:
        gsw = gsw + x
    gkv = torch.cat([gk * G.s1, gv], -1).transpose(1, 2).reshape(B, L, 2 * H * C)
    return (gq.transpose(1, 2).reshape(B, L, H * C) * G.s1, gkv, gqp, torch.cat([gkp, gvp], -1),
            gr[..., :9], gr[..., 9:], gbias, gpz, gsw / G.sw)


@pytest.mark.parametrize("B,L", [(2, 65), (1, 100), (1, 128)])
def test_three_kernel_schedule_matches_plain(B, L):
    """One row past a tile (a last tile of one row and one key), a ragged
    L with ~15% of the keys masked, and two full tiles."""
    args, cots = _inputs(B, L, seed=L)
    _close(three_kernels(args, cots), cuda_ipa.ipa2_bwd_plain(*args, *cots), f"L={L} vs plain")


def test_three_kernel_schedule_matches_jax():
    """The JAX kernel in interpret mode at B=1, L=100."""
    args, cots = _inputs(1, 100, seed=101)
    tojax = lambda x: jnp.asarray(x.float().contiguous().numpy()).astype(
        jnp.bfloat16 if x.dtype == torch.bfloat16 else jnp.float32)
    kern = jax.jit(lambda a, c: P.fused_ipa2_bwd(*a, *c, interpret=True))(
        [tojax(x) for x in args], [tojax(x) for x in cots])
    _close(three_kernels(args, cots), kern, "L=100 vs JAX")
