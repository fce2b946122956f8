"""Fused IPA interior (v2): the CUDA kernels' wrappers, their plain PyTorch
versions and the autograd Function that joins them (counterpart of the JAX
package's ``models/pallas_ipa2.py``).

The function takes everything between the IPA's input projections and its
output projection, in the JAX package's layouts (B batch, L length, H heads,
C channels, Pq / Pv query / value points, CZ4 pair channels):

    q     (B, L, H·C)             scalar queries, head-blocked lanes
    kv    (B, L, 2H·C)            [k_h | v_h] per head block
    qp    (B, H, 3, L, Pq)        local query points, coordinate planes
    kvp   (B, H, 3, L, Pq+Pv)     local key | value points
    r9    (B, L, 9)               row-major backbone rotations; t (B, L, 3)
    bias  (B, H, L, L)            pair bias (linear_b, head-major)
    pz    (B, L, L, CZ4)          down-projected pair (down_z)
    maskb (B, 1, L)               additive key-mask bias inf·(mask − 1)
    sw    (1, H)                  sqrt of the softplus'd point weights

and returns o (B, L, H·C), the local output points (B, L, 3·H·Pv) as
[x | y | z] blocks, their norms (B, L, H·Pv) and the pair readout
(B, L, H·CZ4), all float32: o_feats' pieces in the reference's order.

qp, kvp, bias and pz may be permuted views (the module passes the
projections' natural layouts, and the sampler the EdgeTransition epilogue's
transposed (B, CZ4, L, L) pair readout): the kernels read their strides, so
no transpose is launched. q, kv and the backward's cotangents are contiguous.

The backward (:func:`ipa2_bwd`) recomputes the softmax from the inputs and
returns the nine gradients of ``fused_ipa2_bwd``: q, kv, qp, kvp, r9, t,
bias, pz and the per-batch-row point-weight partials (B, H). :class:`IPA2Fn`
runs the forward and that backward under autograd; the bare forward wrapper
has no autograd and raises when asked to record one.

A tensor on the CPU takes the plain version; a CUDA tensor takes the kernel
or raises: bf16 inputs, H 8, Pq 8, Pv 12, and C 128 with CZ4 16 (the
flagship widths: csrc/ipa2.cu, csrc/ipa2_bwd.cu) or the JAX package's 2x,
4x and 8x widths, C 256, 512 or 1024 with CZ4 32, 64 or 128
(csrc/ipa2_wide.cu: batched GEMMs of csrc/wide_gemm.cuh around row, pair
and column kernels, the (B, H, L, L) attention in device memory between
them; L up to :data:`WIDE_MAX_L`).
"""

from __future__ import annotations

import ctypes
import math

import torch

from pepflowww_torch import native

C_K, PQ_K, PV_K, CZ4_K = 128, 8, 12, 16   # the widths the 1x kernels take
H_K = 8
WIDE_C = (256, 512, 1024)     # the wide kernels' C (the JAX package's 2x, 4x, 8x) ...
WIDE_CZ4 = (32, 64, 128)      # ... and pair channels
WIDE_MAX_L = 4096             # the wide kernels' longest L (ipa2_wide_max_length)
WIDE_POINT_RECORD = 88        # floats of a (b, h, l) global-point record
# The backward (csrc/ipa2_bwd.cu) runs two kernels for L <= TILE, with only
# the heads' (B, H, L, 12) frame-gradient partials as scratch; otherwise three
# kernels over TILE-row tiles with O(L) scratch: the query rows' statistics,
# goptg, both sides' frame-gradient partials, the blocks' gsw partials and
# each row's running sums between tiles.
TILE = 64
_LAYOUT = ctypes.c_longlong * 18          # element strides of qp, kvp (5 each), bias, pz (4 each)
# ipa2_forward: 14 pointers, strides, B, L, H, eps, stream.
_ARGTYPES = [ctypes.c_void_p] * 14 + [ctypes.POINTER(ctypes.c_longlong)] + \
    [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
# ipa2_backward: 14 inputs, 7 scratch (for L <= TILE all null but the third), 9 outputs,
# strides, B, L, H, eps, stream.
_BWD_ARGTYPES = [ctypes.c_void_p] * 30 + [ctypes.POINTER(ctypes.c_longlong)] + \
    [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
# ipa2_wide_forward: 10 inputs, 3 scratch, 4 outputs, strides, B, L, C, cz4, eps, stream.
_WIDE_ARGTYPES = [ctypes.c_void_p] * 17 + [ctypes.POINTER(ctypes.c_longlong)] + \
    [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
# ipa2_wide_backward: 14 inputs, 12 scratch, 9 outputs, strides, B, L, C, cz4, eps, stream.
_WIDE_BWD_ARGTYPES = [ctypes.c_void_p] * 35 + [ctypes.POINTER(ctypes.c_longlong)] + \
    [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]


def _dims(q, qp, kvp):
    H = qp.shape[1]
    C = q.shape[-1] // H
    Pq = qp.shape[-1]
    return H, C, Pq, kvp.shape[-1] - Pq


def _scales(C):
    return 1.0 / math.sqrt(3 * C), 1.0 / math.sqrt(3.0)


# ---------------------------------------------------------------- plain versions
def _geometry(qp, kvp, r9, t, sw):
    """R (B, L, 3, 3), the global points qg, kg (scaled by sw) and vg, each
    (B, H, 3, L, P): u_c = (Σ_d R[c, d] x_d + t_c) · scale."""
    B, H, _, L, Pq = qp.shape
    R = r9.float().reshape(B, L, 3, 3)
    tt = t.float().transpose(1, 2)[:, None, :, :, None]

    def to_global(x, scale):
        return (torch.einsum("blcd,bhdlp->bhclp", R, x.float()) + tt) * scale

    swb = sw.float().reshape(1, H, 1, 1, 1)
    return R, to_global(qp, swb), to_global(kvp[..., :Pq], swb), to_global(kvp[..., Pq:], 1.0)


def _softmax(q, kv, bias, maskb, qg, kg, H, C):
    """Attention weights a (B, H, L, L) in float32: q·kᵀ of the inputs'
    values (bf16 operands are exact in float32) ·s1, + bias·s2, − ½‖q−k‖²
    through the square expansion, + the key mask."""
    B, L = q.shape[:2]
    s1, s2 = _scales(C)
    qh = q.float().reshape(B, L, H, C)
    kh = kv.float().reshape(B, L, H, 2 * C)[..., :C]
    a = torch.einsum("blhc,bmhc->bhlm", qh, kh) * s1 + bias.float() * s2
    q_sq = qg.square().sum((2, 4))
    k_sq = kg.square().sum((2, 4))
    qk = torch.einsum("bhclp,bhcmp->bhlm", qg, kg)
    a = a - 0.5 * (q_sq[..., :, None] + k_sq[..., None, :] - 2.0 * qk)
    return torch.softmax(a + maskb.float()[:, :, None, :], -1)


def _local(R, optg, t, eps):
    """(dif, local points Rᵀ(o − t), norms √(Σ_c local_c² + eps))."""
    dif = optg - t.float().transpose(1, 2)[:, None, :, :, None]
    optl = torch.einsum("bldc,bhdlp->bhclp", R, dif)
    return dif, optl, torch.sqrt(optl.square().sum(2) + eps)


def ipa2_plain(q, kv, qp, kvp, r9, t, bias, pz, maskb, sw, eps: float = 1e-8):
    """The forward kernel's arithmetic in plain PyTorch (``ipa2_reference``
    at ``_fwd_kernel``'s rounding points): float32 softmax; the scalar output
    from the weights rounded to kv's dtype, the point and pair outputs from
    the float32 weights. Returns (o, o_ptl, norm, opair), float32."""
    H, C, Pq, Pv = _dims(q, qp, kvp)
    B, L = q.shape[:2]
    R, qg, kg, vg = _geometry(qp, kvp, r9, t, sw)
    a = _softmax(q, kv, bias, maskb, qg, kg, H, C)
    a_c = a.to(kv.dtype).float()
    vh = kv.float().reshape(B, L, H, 2 * C)[..., C:]
    o = torch.einsum("bhlm,bmhc->blhc", a_c, vh).reshape(B, L, H * C)
    _, optl, norm = _local(R, torch.einsum("bhlm,bhcmp->bhclp", a, vg), t, eps)
    opair = torch.einsum("bhlm,blmd->blhd", a, pz.float()).reshape(B, L, -1)
    return (o, optl.permute(0, 3, 2, 1, 4).reshape(B, L, 3 * H * Pv),
            norm.permute(0, 2, 1, 3).reshape(B, L, H * Pv), opair)


def ipa2_bwd_plain(q, kv, qp, kvp, r9, t, bias, pz, maskb, sw, go, goptl, gnorm, gopair,
                   eps: float = 1e-8):
    """The backward kernel's arithmetic (``_bwd_kernel``) in plain PyTorch:
    the forward recomputed, then the cotangents of the point norms and the
    inverse transform, the attention-weight gradient from all three
    aggregations (go rounded to kv's dtype for the scalar one), the softmax
    backward, and the frame-transform backward; gs rounded to q's dtype
    before the q and k products, as the kernel rounds it. Returns (gq, gkv,
    gqp, gkvp, gr9, gt, gbias, gpz, gsw (B, H)), float32."""
    H, C, Pq, Pv = _dims(q, qp, kvp)
    B, L = q.shape[:2]
    CZ4 = pz.shape[-1]
    s1, s2 = _scales(C)
    dt = kv.dtype
    R, qg, kg, vg = _geometry(qp, kvp, r9, t, sw)
    a = _softmax(q, kv, bias, maskb, qg, kg, H, C)
    a_c = a.to(dt).float()
    qh = q.float().reshape(B, L, H, C)
    kvh = kv.float().reshape(B, L, H, 2 * C)
    kh, vh = kvh[..., :C], kvh[..., C:]
    dif, optl, norm = _local(R, torch.einsum("bhlm,bhcmp->bhclp", a, vg), t, eps)

    goc = go.to(dt).float().reshape(B, L, H, C)
    gnorm_h = gnorm.float().reshape(B, L, H, Pv).permute(0, 2, 1, 3)
    gopair_h = gopair.float().reshape(B, L, H, CZ4)
    gl = goptl.float().reshape(B, L, 3, H, Pv).permute(0, 3, 2, 1, 4) \
        + optl * (gnorm_h / norm)[:, :, None]
    goptg = torch.einsum("bldc,bhclp->bhdlp", R, gl)
    gR = torch.einsum("bhdlp,bhclp->bldc", dif, gl)
    gT = -goptg.sum((1, 4)).transpose(1, 2)

    g_a = (torch.einsum("blhc,bmhc->bhlm", goc, vh)
           + torch.einsum("bhclp,bhcmp->bhlm", goptg, vg)
           + torch.einsum("blhd,blmd->bhlm", gopair_h, pz.float()))
    gv = torch.einsum("bhlm,blhc->bmhc", a_c, goc)
    gvg = torch.einsum("bhlm,bhclp->bhcmp", a, goptg)
    gpz = torch.einsum("bhlm,blhd->blmd", a, gopair_h)
    gs = a * (g_a - (a * g_a).sum(-1, keepdim=True))
    gsc = gs.to(q.dtype).float()
    gq = torch.einsum("bhlm,bmhc->blhc", gsc, kh) * s1
    gk = torch.einsum("bhlm,blhc->bmhc", gsc, qh) * s1
    gqg = -gs.sum(-1)[:, :, None, :, None] * qg + torch.einsum("bhlm,bhcmp->bhclp", gs, kg)
    gkg = -gs.sum(-2)[:, :, None, :, None] * kg + torch.einsum("bhlm,bhclp->bhcmp", gs, qg)
    swf = sw.float().reshape(1, H)
    gsw = ((gqg * qg).sum((2, 3, 4)) + (gkg * kg).sum((2, 3, 4))) / swf

    def tfm_bwd(gu, x, scale):
        """u_c = (Σ_d R[c, d] x_d + t_c)·scale: d x, and the rows' d t, d R."""
        nonlocal gR, gT
        gx = torch.einsum("blcd,bhclp->bhdlp", R, gu) * scale
        gT = gT + (gu * scale).sum((1, 4)).transpose(1, 2)
        gR = gR + torch.einsum("bhdlp,bhclp->blcd", x.float(), gu * scale)
        return gx

    swb = swf.reshape(1, H, 1, 1, 1)
    gqp = tfm_bwd(gqg, qp, swb)
    gkvp = torch.cat([tfm_bwd(gkg, kvp[..., :Pq], swb), tfm_bwd(gvg, kvp[..., Pq:], 1.0)], -1)
    gkv = torch.cat([gk, gv], -1).reshape(B, L, 2 * H * C)
    return (gq.reshape(B, L, H * C), gkv, gqp, gkvp, gR.reshape(B, L, 9), gT, gs * s2, gpz, gsw)


# ---------------------------------------------------------------- kernels
def check_widths(H: int, C: int, Pq: int, Pv: int, cz4: int) -> bool:
    """Raise unless the kernels take these widths; True for the wide
    kernels' (C 256, 512, 1024 with CZ4 32, 64, 128), False for the 1x
    ones' (C 128, CZ4 16), both at H 8, Pq 8, Pv 12."""
    wide = C in WIDE_C and cz4 in WIDE_CZ4
    if (H, Pq, Pv) != (H_K, PQ_K, PV_K) or not (wide or (C, cz4) == (C_K, CZ4_K)):
        raise ValueError(f"the IPA kernels take H={H_K}, Pq={PQ_K}, Pv={PV_K} with C={C_K}, "
                         f"CZ4={CZ4_K} or C in {WIDE_C}, CZ4 in {WIDE_CZ4}; got H={H}, C={C}, "
                         f"Pq={Pq}, Pv={Pv}, CZ4={cz4}")
    return wide


def _check_widths(q, qp, kvp, pz):
    """(H, C, CZ4, wide) of the inputs, or raise."""
    H, C, Pq, Pv = _dims(q, qp, kvp)
    if q.shape[-1] != H * C:
        raise ValueError(f"q is {q.shape[-1]} wide, not a multiple of H={H}")
    wide = check_widths(H, C, Pq, Pv, pz.shape[-1])
    if wide and q.shape[1] > WIDE_MAX_L:
        raise ValueError(f"L = {q.shape[1]}: the wide IPA kernels take L <= {WIDE_MAX_L}")
    return H, C, pz.shape[-1], wide


def _kernel_inputs(q, kv, qp, kvp, r9, t, bias, pz, maskb, sw, pz_rows=False):
    """Check what the kernels read; returns (H, C, CZ4, wide, inputs,
    strides). With `pz_rows` (the 1x backward) pz comes as each pair's
    channels in a row (:func:`_pairs_by_rows`); the wide kernels read any
    layout through its strides."""
    H, C, cz4, wide = _check_widths(q, qp, kvp, pz)
    if pz_rows and not wide:
        pz = _pairs_by_rows(pz)
    B, L = q.shape[:2]
    bf, f32 = torch.bfloat16, torch.float32
    native.check_tensor(q, "q", (B, L, H * C), bf)
    native.check_tensor(kv, "kv", (B, L, 2 * H * C), bf)
    # The kernels read these four through their strides: views pass as they are.
    native.check_tensor(qp, "qp", (B, H, 3, L, PQ_K), bf, contiguous=False)
    native.check_tensor(kvp, "kvp", (B, H, 3, L, PQ_K + PV_K), bf, contiguous=False)
    native.check_tensor(bias, "bias", (B, H, L, L), bf, contiguous=False)
    native.check_tensor(pz, "pz", (B, L, L, cz4), bf, contiguous=False)
    r9, t = r9.to(f32).contiguous(), t.to(f32).contiguous()
    maskb, sw = maskb.to(f32).contiguous(), sw.to(f32).contiguous()
    native.check_tensor(r9, "r9", (B, L, 9), f32)
    native.check_tensor(t, "t", (B, L, 3), f32)
    native.check_tensor(maskb, "maskb", (B, 1, L), f32)
    native.check_tensor(sw, "sw", (1, H), f32)
    strides = _LAYOUT(*qp.stride(), *kvp.stride(), *bias.stride(), *pz.stride())
    return H, C, cz4, wide, [q, kv, qp, kvp, r9, t, bias, pz, maskb, sw], strides


def wide_scratch(B: int, L: int, C: int, backward: bool) -> dict:
    """The wide kernels' scratch at these sizes (H 8): name -> (shape,
    dtype), in the entry points' order. Lp = L rounded up to 8 is the row
    length of the (B, H, L, L) matrices: the GEMMs read their bf16 copies in
    16-byte chunks and write fp32 pairs."""
    H, Lp, f32, bf = H_K, -(-L // 8) * 8, torch.float32, torch.bfloat16
    bhl = (B * H * L,)
    out = {"P": ((B * H * L, WIDE_POINT_RECORD), f32), "S": ((B * H * L, Lp), f32)}
    if backward:
        out.update(G=((B * H * L, Lp), f32), gob=((B, L, H * C), bf))
    out["ac"] = ((B * H, Lp, Lp), bf)
    if backward:
        out.update(gsc=((B * H, Lp, Lp), bf), gsct=((B * H, Lp, Lp), bf),
                   GO=((B * H * L, 3 * PV_K), f32), RTq=((B * H * L, 12), f32),
                   RTk=((B * H * L, 12), f32), SWq=(bhl, f32), SWk=(bhl, f32))
    return out


def _wide_scratch(B, L, C, backward, dev):
    return [torch.empty(*shape, dtype=dt, device=dev)
            for shape, dt in wide_scratch(B, L, C, backward).values()]


def _pairs_by_rows(pz):
    """pz as the backward's kernels read it: each pair's CZ4 channels as
    contiguous, 16-byte aligned bytes. The training step's down_z output
    already is; any other layout is copied."""
    st = pz.stride()
    if pz.dim() != 4 or (st[3] == 1 and all(x % 8 == 0 for x in st[:3])
                         and pz.data_ptr() % 16 == 0):
        return pz
    return pz.contiguous()


def fused_ipa2(q, kv, qp, kvp, r9, t, bias, pz, maskb, sw, eps: float = 1e-8):
    """IPA interior forward, without autograd: it raises if grad mode is on
    and an input requires grad (use :class:`IPA2Fn` to train). CPU tensors
    run :func:`ipa2_plain`; CUDA tensors run the kernel or raise."""
    native.refuse_autograd("fused_ipa2", [q, kv, qp, kvp, r9, t, bias, pz, sw])
    return _forward(q, kv, qp, kvp, r9, t, bias, pz, maskb, sw, eps)


def _forward(q, kv, qp, kvp, r9, t, bias, pz, maskb, sw, eps=1e-8):
    if q.device.type == "cpu":
        return ipa2_plain(q, kv, qp, kvp, r9, t, bias, pz, maskb, sw, eps)
    H, C, cz4, wide, ins, strides = _kernel_inputs(q, kv, qp, kvp, r9, t, bias, pz, maskb, sw)
    B, L = q.shape[:2]
    empty = lambda *s: torch.empty(*s, dtype=torch.float32, device=q.device)
    outs = [empty(B, L, H * C), empty(B, L, 3 * H * PV_K), empty(B, L, H * PV_K),
            empty(B, L, H * cz4)]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if wide:   # K7 at 2x-8x: csrc/ipa2_wide.cu's five launches, counted as one call
        fn = native.function("ipa2_wide", "ipa2_wide_forward", _WIDE_ARGTYPES)
        scratch = _wide_scratch(B, L, C, False, q.device)
        rc = fn(*[x.data_ptr() for x in ins + scratch + outs], strides, B, L, C, cz4, eps, stream)
    else:
        fn = native.function("ipa2", "ipa2_forward", _ARGTYPES)
        rc = fn(*[x.data_ptr() for x in ins + outs], strides, B, L, H, eps, stream)
    native.check(rc, "ipa2")
    native.count_launch("ipa2")
    return tuple(outs)


def ipa2_bwd(q, kv, qp, kvp, r9, t, bias, pz, maskb, sw, go, goptl, gnorm, gopair,
             eps: float = 1e-8):
    """Gradients of the IPA interior for the cotangents of its four outputs:
    (gq, gkv, gqp, gkvp, gr9, gt, gbias, gpz, gsw (B, H)), float32, in the
    inputs' shapes. CPU tensors run :func:`ipa2_bwd_plain`; CUDA tensors run
    the backward kernels or raise: at the 1x widths two for L <= TILE, else
    three, none with (B, H, L, L) scratch; at the wide widths twelve
    (csrc/ipa2_wide.cu). Two calls on the same inputs give bit-identical
    results: sums across blocks are per-block partials added in a fixed
    order, not atomics."""
    if q.device.type == "cpu":
        return ipa2_bwd_plain(q, kv, qp, kvp, r9, t, bias, pz, maskb, sw, go, goptl, gnorm,
                              gopair, eps)
    B, L = q.shape[:2]
    H, C, cz4, wide, ins, strides = _kernel_inputs(q, kv, qp, kvp, r9, t, bias, pz, maskb, sw,
                                                   pz_rows=True)
    f32, dev = torch.float32, q.device
    cots = [x.to(f32).contiguous() for x in (go, goptl, gnorm, gopair)]
    for x, name, w in zip(cots, ("go", "goptl", "gnorm", "gopair"),
                          (H * C, 3 * H * PV_K, H * PV_K, H * cz4)):
        native.check_tensor(x, name, (B, L, w), f32)
    empty = lambda *s: torch.empty(*s, dtype=f32, device=dev)
    outs = [empty(B, L, H * C), empty(B, L, 2 * H * C), empty(B, H, 3, L, PQ_K),
            empty(B, H, 3, L, PQ_K + PV_K), empty(B, L, 9), empty(B, L, 3), empty(B, H, L, L),
            empty(B, L, L, cz4), empty(B, H)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    if wide:   # K8 at 2x-8x: csrc/ipa2_wide.cu's twelve launches, counted as one call
        fn = native.function("ipa2_wide", "ipa2_wide_backward", _WIDE_BWD_ARGTYPES)
        scratch = _wide_scratch(B, L, C, True, dev)
        rc = fn(*[x.data_ptr() for x in ins + cots + scratch + outs], strides, B, L, C, cz4, eps,
                stream)
        native.check(rc, "ipa2_bwd")
        native.count_launch("ipa2_bwd")
        return tuple(outs)
    if L <= TILE:
        scratch = [None] * 2 + [empty(B, H, L, 12)] + [None] * 4
    else:
        n_t = (L + TILE - 1) // TILE
        scratch = [empty(B, H, L, 4), empty(B, H, L, 40), empty(B, H, L, 12),
                   empty(B, H, L, 12), empty(B, H, n_t), empty(B, H, n_t), empty(B, H, n_t * TILE, 64)]
    fn = native.function("ipa2_bwd", "ipa2_backward", _BWD_ARGTYPES)
    ptrs = [None if x is None else x.data_ptr() for x in ins + cots + scratch + outs]
    rc = fn(*ptrs, strides, B, L, H, eps, stream)
    native.check(rc, "ipa2_bwd")
    native.count_launch("ipa2_bwd")
    return tuple(outs)


class IPA2Fn(torch.autograd.Function):
    """The IPA interior under autograd, the counterpart of
    ``fused_ipa2_vjp``: the forward runs the forward kernel and saves only
    its inputs; the backward runs the backward kernel and returns each
    gradient in its input's dtype, none for the 0/−inf key mask, and the
    point-weight gradient as the sum of the per-batch-row partials (one
    reduction over B in a fixed order). On the CPU both directions take
    their plain versions.

    apply(q, kv, qp, kvp, r9, t, bias, pz, maskb, sw, eps)"""

    @staticmethod
    def forward(ctx, q, kv, qp, kvp, r9, t, bias, pz, maskb, sw, eps):
        ctx.save_for_backward(q, kv, qp, kvp, r9, t, bias, pz, maskb, sw)
        ctx.eps = eps
        return _forward(q, kv, qp, kvp, r9, t, bias, pz, maskb, sw, eps)

    @staticmethod
    def backward(ctx, go, goptl, gnorm, gopair):
        ins = ctx.saved_tensors
        grads = ipa2_bwd(*ins, go, goptl, gnorm, gopair, eps=ctx.eps)
        *g8, gsw = grads
        out = [g.to(x.dtype) for g, x in zip(g8, ins[:8])]
        return (*out, None, gsw.sum(0, keepdim=True).to(ins[9].dtype), None)
