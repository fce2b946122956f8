"""Fused EdgeTransition: the CUDA kernels' wrappers, their plain PyTorch
versions and the autograd Function that joins them (counterpart of the JAX
package's ``models/pallas_edge.py`` and ``models/pallas_edge_bwd.py``).

The function takes the EdgeTransition after its initial node Linear:
``edge`` (B, L, L, 64), ``node_bias`` (B, L, 64) and the node mask (B, L);
the pair mask is the mask's outer product. ``p`` holds the weights in
[in, out] layout: k1 (192, 192), b1, k2 (192, 192), b2, k3 (192, 64), b3,
ln_scale, ln_bias. With ``readout=(kb, bb, kdz, bdz)`` (the NEXT IPA
block's linear_b (64, H) and down_z (64, c_z/4), [in, out]) it also returns
that block's pair readouts, transposed: b (B, H, L, L) and pz (B, c_z/4, L, L).

The int8 serving profile (:func:`fused_edge_transition_int8`, the JAX
kernel's ``quant_int8=True``) runs the two hidden-width products (h1.k2,
h2.k3) as int8 x int8 -> int32 with per-row activation scales
(:func:`quant_rows`) and per-output-column weight scales (:func:`quant_cols`,
of the float32 parameters); everything else is the bf16 function's. It is
forward-only, as in the JAX package. Its kernel (K6) shares the bf16
kernel's tile loop (csrc/edge_transition.cuh) and quantizes the hidden rows
in registers, feeding them to the int8 products in the order they lie
there; so the int8 weights it reads have their K axis permuted by
:data:`INT8_K_PERM`.

The backward (:func:`edge_transition_bwd`) takes the same inputs and the
output's cotangent ``g`` and returns d_edge, d_node_bias and the eight
parameter gradients, recomputing both hidden layers. :class:`EdgeTransitionFn`
runs the forward (readout off) and that backward under autograd; the bare
forward wrappers have no autograd and raise when asked to record one.

The bf16 kernels take c_z = 64 (the flagship width: node bias 64, hidden
192, at most 32 readout lanes) and the JAX package's 2x, 4x and 8x widths,
c_z = 128, 256, 512 (node bias c_z, hidden 3 c_z, at most 8 + c_z/4
readout lanes: the next block's H = 8 heads and c_z/4 pair channels), each
read from the operands; at the wider ones their ``*_wide_*`` entry points
run the tiled-GEMM design of csrc/wide_gemm.cuh. Any other width raises
(:func:`check_widths`). The int8 kernel (K6) takes c_z = 64 only.

A tensor on the CPU takes the plain version; a CUDA tensor takes the kernel
(csrc/edge_transition.cu, csrc/edge_transition_int8.cu,
csrc/edge_transition_bwd.cu) or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from pepflowww_torch import native

CZ, HID, RO = 64, 192, 32
WIDE_CZ = (128, 256, 512)   # the JAX package's 2x, 4x, 8x pair widths (csrc/wide_gemm.cuh)
WIDE_RO_TILE = 64           # the wide readout's lanes are padded to a multiple of this
PARAM_NAMES = ("k1", "b1", "k2", "b2", "k3", "b3", "ln_scale", "ln_bias")
# edge_transition_forward: 16 pointers, B, L, n_b, n_pz, eps, stream.
_ARGTYPES = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
# edge_transition_int8_forward: 19 pointers, B, L, n_b, n_pz, eps, stream.
_INT8_ARGTYPES = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
# edge_transition_backward: 30 pointers, B, L, grid, n1, n2, n3, d_edge_f32, eps, stream.
_BWD_ARGTYPES = [ctypes.c_void_p] * 30 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
# edge_transition_wide_forward: 21 pointers, B, L, cz, n_b, n_pz, ro_pad, eps, stream.
_WIDE_ARGTYPES = [ctypes.c_void_p] * 21 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
# edge_transition_wide_backward: 40 pointers, B, L, cz, ks1, ks2, ks3, d_edge_f32, eps, stream.
_WIDE_BWD_ARGTYPES = [ctypes.c_void_p] * 40 + [ctypes.c_int] * 7 + [ctypes.c_float,
                                                                    ctypes.c_void_p]
WIDE_ROWS = 128      # pair rows of a wide GEMM block: one column-sum partial row each
BWD_TI = 8           # the backward kernel's tile: 8 x 8 pairs (i, j) of one batch row
BWD_COL_SLOTS = 4    # column partials of d_node a tile writes per column (one a warp)
VEC = 2 * HID + 3 * CZ   # per-block partial: d_b1 | d_b2 | d_b3 | d_ln_scale | d_ln_bias
INT8_HINT = ("train without quant_int8: the int8 serving profile is forward-only, as in the "
             "JAX package")
# What the kernels read of their operands: name -> (shape, dtype).
_OPERANDS = {"b1": ((HID,), torch.float32),
             "b2": ((HID,), torch.float32), "b3": ((CZ,), torch.float32),
             "ln_scale": ((CZ,), torch.float32), "ln_bias": ((CZ,), torch.float32),
             "w1t": ((HID, HID), torch.bfloat16), "w2t": ((HID, HID), torch.bfloat16),
             "w3t": ((CZ, HID), torch.bfloat16),
             "wrt": ((RO, CZ), torch.bfloat16), "bro": ((RO,), torch.float32),
             "w2qt": ((HID, HID), torch.int8), "w2s": ((HID,), torch.float32),
             "w3qt": ((CZ, HID), torch.int8), "w3s": ((CZ,), torch.float32)}


def _round(x: torch.Tensor, dtype) -> torch.Tensor:
    """x rounded to `dtype` and brought back to float32: a product of two
    such values is exact in float32, so a float32 matmul of them is a
    `dtype` product with float32 accumulation."""
    return x.to(dtype).float()


def _node_terms(n, k, cz, rows: slice = slice(None)):
    """n_i.k[cz:cz+cb] (B, rows, 1, N) and n_j.k[cz+cb:] (B, 1, L, N)."""
    cb = n.shape[-1]
    return (n[:, rows] @ k[cz:cz + cb])[:, :, None, :], (n @ k[cz + cb:])[:, None, :, :]


def _output(o, node_mask, p, dtype, readout, eps, rows: slice = slice(None)):
    """LayerNorm (float32 statistics), pair mask, rounding to `dtype` and,
    with a readout, the next block's transposed b and pz from that output."""
    o = F.layer_norm(o, (o.shape[-1],), p["ln_scale"].float(), p["ln_bias"].float(), eps)
    m = node_mask.float()
    out = (o * (m[:, rows, None] * m[:, None, :])[..., None]).to(dtype)
    if readout is None:
        return out
    kb, bb, kdz, bdz = readout
    ob = out.float()
    bt = (ob @ _round(kb, dtype) + bb.float()).to(dtype).permute(0, 3, 1, 2).contiguous()
    pzt = (ob @ _round(kdz, dtype) + bdz.float()).to(dtype).permute(0, 3, 1, 2).contiguous()
    return out, bt, pzt


def edge_transition_plain(edge, node_bias, node_mask, p: dict, dtype=torch.bfloat16,
                          readout: Optional[tuple] = None, eps: float = 1e-5,
                          rows: slice = slice(None)):
    """The kernel's arithmetic in plain PyTorch: operands rounded to `dtype`
    at the points the kernel rounds them, float32 accumulation, LayerNorm
    statistics in float32. In float32 it is the reference EdgeTransition
    (with the first layer and the residual projection factorized). With
    `rows`, `edge` holds the query rows of that slice (pair-row TP's part,
    ``parallel/tp.py``): the i-side node terms and the pair mask come from
    those rows of `node_bias` and `node_mask`, the j-side from all."""
    cz = edge.shape[-1]
    e = _round(edge, dtype)
    n = _round(node_bias, dtype)
    k1, k3 = _round(p["k1"], dtype), _round(p["k3"], dtype)

    def factorized(k):
        y_i, y_j = _node_terms(n, k, cz, rows)
        return e @ k[:cz] + y_i + y_j

    h = torch.relu(factorized(k1) + p["b1"].float())
    h = torch.relu(_round(h, dtype) @ _round(p["k2"], dtype) + p["b2"].float())
    o = _round(h, dtype) @ k3 + factorized(k3) + p["b3"].float()
    return _output(o, node_mask, p, dtype, readout, eps, rows)


# ---------------------------------------------------------------- int8
def quant_rows(x: torch.Tensor, limit: float = 127.0):
    """Symmetric per-row int8 quantization of a (..., N) float32 tensor (the
    JAX kernel's ``_quant_rows``): amax over the row, inv = limit/amax (0 for
    an all-zero row), q = round-half-even(x * inv). Returns (q int8, row
    scale amax/limit (..., 1) float32)."""
    amax = x.abs().amax(-1, keepdim=True)
    inv = torch.where(amax > 0, limit / amax, torch.zeros_like(amax))
    return torch.round(x * inv).to(torch.int8), amax / limit


def quant_cols(w: torch.Tensor):
    """Symmetric per-output-column int8 quantization of a (K, N) weight (the
    JAX wrapper's ``_quant_cols``), from its float32 values: (q int8 (K, N),
    column scale (1, N) float32)."""
    w = w.float()
    amax = w.abs().amax(0, keepdim=True)
    inv = torch.where(amax > 0, 127.0 / amax, torch.zeros_like(amax))
    return torch.round(w * inv).to(torch.int8), amax / 127.0


def _int8_k_perm() -> torch.Tensor:
    """The order in which K6 feeds a hidden row to its int8 products: entry
    p is the hidden column at position p of the K axis. Within each 32-column
    block, the wgmma A fragment of lane q of a quad holds positions 4q..4q+3
    and 16+4q..19+4q, and the fp32 accumulator it is packed from holds
    columns 2q, 2q+1, 8+2q, 9+2q and the same +16: position 4q + m holds
    column 2q + (m & 1) + 8 (m >> 1), and position 16 + 4q + m that + 16."""
    q, m = torch.meshgrid(torch.arange(4), torch.arange(4), indexing="ij")
    half = (2 * q + (m & 1) + 8 * (m >> 1)).reshape(-1)
    block = torch.cat([half, half + 16])
    return torch.cat([block + 32 * b for b in range(HID // 32)])


INT8_K_PERM = _int8_k_perm()


def _int_product(q, wq):
    """q . wq of int8 values as a float32 matmul of the integers: exact,
    since |sum| <= 192 * 127 * 127 < 2^24 (float32 products in full float32,
    no TF32)."""
    return q.float() @ wq.float()


def edge_transition_int8_plain(edge, node_bias, node_mask, p: dict, dtype=torch.bfloat16,
                               readout: Optional[tuple] = None, eps: float = 1e-5):
    """The int8 kernel's arithmetic in plain PyTorch, at the JAX kernel's
    rounding points (``pallas_edge._kernel`` with quant_int8, int8_w3): h1
    from `dtype` operands with float32 accumulation, kept float32 and
    quantized per row; h2 = relu(float(q1.W2q) * s1 * w2s + b2), quantized
    again; o = float(q2.W3q) * s2 * w3s + e.W3e + n_i.W3i + n_j.W3j + b3
    with the 64-wide rows of W3 from its `dtype` cast; then the bf16
    function's LayerNorm, mask and readout. W2q, W3q quantize the float32
    k2, k3 per output column."""
    cz = edge.shape[-1]
    e = _round(edge, dtype)
    n = _round(node_bias, dtype)
    k1, k3 = _round(p["k1"], dtype), _round(p["k3"], dtype)
    y_i, y_j = _node_terms(n, k1, cz)
    h = torch.relu(e @ k1[:cz] + y_i + y_j + p["b1"].float())
    q, hs = quant_rows(h)
    w2q, w2s = quant_cols(p["k2"])
    h = torch.relu(_int_product(q, w2q) * hs * w2s + p["b2"].float())
    q, hs = quant_rows(h)
    w3q, w3s = quant_cols(p["k3"])
    o = _int_product(q, w3q) * hs * w3s + e @ k3[:cz]
    y_i, y_j = _node_terms(n, k3, cz)
    o = o + y_i + y_j + p["b3"].float()
    return _output(o, node_mask, p, dtype, readout, eps)


# ---------------------------------------------------------------- kernels
def check_widths(cz: int, cb: int, hid: int, n_ro: Optional[int] = None,
                 quant_int8: bool = False) -> None:
    """Raise unless the kernels take these widths: c_z 64 (the flagship
    kernels) or 128, 256, 512 (the wide ones), a c_z-wide node bias, hidden
    3 c_z, and with a readout at most 32 lanes at c_z 64 and 8 + c_z/4 from
    128 on (the next block's heads and down_z channels); the int8 kernel
    takes c_z 64 only."""
    if cz != CZ and cz not in WIDE_CZ:
        raise ValueError(f"c_z = {cz} is not supported by the EdgeTransition kernels (64, 128, "
                         "256 or 512)")
    if cb != cz or hid != 3 * cz:
        raise ValueError(f"node bias {cb} and hidden {hid} wide at c_z = {cz}: the EdgeTransition "
                         f"kernels take a node bias of c_z and a hidden width of 3 c_z = {3 * cz}")
    if quant_int8 and cz != CZ:
        raise ValueError(f"the int8 EdgeTransition kernel takes c_z = 64 only, not {cz}")
    if n_ro is not None:
        most = RO if cz == CZ else 8 + cz // 4
        if n_ro > most:
            raise ValueError(f"{n_ro} readout lanes at c_z = {cz}: the EdgeTransition kernels "
                             f"take at most {most}")


def _param_widths(p: dict):
    """(c_z, node bias width, hidden width) of the parameters."""
    cz, hid = p["k3"].shape[1], p["k1"].shape[1]
    return cz, (p["k1"].shape[0] - cz) // 2, hid


def kernel_operands(p: dict, readout: Optional[tuple] = None, quant_int8: bool = False) -> dict:
    """The weights as the kernels take them: float32 vectors; the matrices
    K-major, bf16 transposed to [out, in] (w1t, w3t, and without
    `quant_int8` w2t; the backward kernel reads the same copies); the
    readout packed as [kb | kdz | 0] and transposed, wrt (32, 64), with its
    bias (32,). With `quant_int8`, in place of w2t, k2 and k3 quantized per
    output column (from float32) and transposed to [out, in] int8, their K
    axis permuted by :data:`INT8_K_PERM` (w2qt, w3qt), with their column
    scales (w2s, w3s).

    At c_z 128, 256, 512 the wide kernels also take wn, the node rows of k1
    and k3 transposed ([W1i | W1j | W3i | W3j]^T, (2 hid + 2 c_z, c_z)), the
    backward's k1b, k2b, k3b (the bf16 weights as stored, [in, out]), and
    the readout padded to a multiple of 64 lanes, wrt (lanes, c_z).
    Unsupported widths raise (:func:`check_widths`)."""
    bf = torch.bfloat16
    cz, cb, hid = _param_widths(p)
    n_ro = None if readout is None else readout[0].shape[1] + readout[2].shape[1]
    check_widths(cz, cb, hid, n_ro, quant_int8)
    ops = {k: p[k].float().contiguous() for k in ("b1", "b2", "b3", "ln_scale", "ln_bias")}
    if quant_int8:
        ops.update({f"w{k}t": p[f"k{k}"].to(bf).t().contiguous() for k in ("1", "3")})
        for k in ("2", "3"):
            q, scale = quant_cols(p[f"k{k}"])
            perm = INT8_K_PERM.to(q.device)
            ops.update({f"w{k}qt": q.t()[:, perm].contiguous(),
                        f"w{k}s": scale.reshape(-1).contiguous()})
    else:
        ops.update({f"w{k}t": p[f"k{k}"].to(bf).t().contiguous() for k in ("1", "2", "3")})
    if cz != CZ:
        k1, k3 = p["k1"].to(bf), p["k3"].to(bf)
        ops["wn"] = torch.cat([k1[cz:2 * cz].t(), k1[2 * cz:].t(), k3[cz:2 * cz].t(),
                               k3[2 * cz:].t()]).contiguous()
        ops.update({f"k{k}b": p[f"k{k}"].to(bf).contiguous() for k in ("1", "2", "3")})
    if readout is not None:
        kb, bb, kdz, bdz = readout
        n_b, n_pz = kb.shape[1], kdz.shape[1]
        if kb.shape[0] != cz or kdz.shape[0] != cz:
            raise ValueError(f"readout widths {tuple(kb.shape)}, {tuple(kdz.shape)} are not "
                             f"supported by the kernel ({cz} in)")
        lanes = RO if cz == CZ else -(-n_ro // WIDE_RO_TILE) * WIDE_RO_TILE
        wr = torch.zeros(cz, lanes, dtype=bf, device=kb.device)
        wr[:, :n_b] = kb.to(bf)
        wr[:, n_b:n_b + n_pz] = kdz.to(bf)
        bro = torch.zeros(lanes, dtype=torch.float32, device=kb.device)
        bro[:n_b] = bb.float()
        bro[n_b:n_b + n_pz] = bdz.float()
        ops.update(wrt=wr.t().contiguous(), bro=bro, n_b=n_b, n_pz=n_pz)
    return ops


def _wide_operands(cz: int, lanes: int = 0) -> dict:
    """What the wide kernels read of their operands at c_z = cz: name ->
    (shape, dtype)."""
    hid, bf, f32 = 3 * cz, torch.bfloat16, torch.float32
    return {"b1": ((hid,), f32), "b2": ((hid,), f32), "b3": ((cz,), f32),
            "ln_scale": ((cz,), f32), "ln_bias": ((cz,), f32),
            "w1t": ((hid, hid), bf), "w2t": ((hid, hid), bf), "w3t": ((cz, hid), bf),
            "wn": ((2 * hid + 2 * cz, cz), bf), "k1b": ((hid, hid), bf),
            "k2b": ((hid, hid), bf), "k3b": ((hid, cz), bf),
            "wrt": ((lanes, cz), bf), "bro": ((lanes,), f32)}


def _check_ops(ops: dict, names, shapes: dict, hint: str) -> None:
    for k in names:
        if k not in ops:
            raise ValueError(f"the kernel needs operand {k}: make ops with {hint} to match")
        native.check_tensor(ops[k], k, *shapes[k])


def fused_edge_transition(edge, node_bias, node_mask, p: dict, dtype=torch.bfloat16,
                          readout: Optional[tuple] = None, ops: Optional[dict] = None,
                          eps: float = 1e-5):
    """EdgeTransition forward (readout optional), without autograd: it raises
    if grad mode is on and an input requires grad (use
    :class:`EdgeTransitionFn` to train). CPU tensors run
    :func:`edge_transition_plain`; CUDA tensors run the bf16 kernel, which
    takes c_z = 64, 128, 256 or 512 with a c_z-wide node bias and hidden
    width 3 c_z, and raises on anything else. ``ops`` may carry
    :func:`kernel_operands` made once."""
    native.refuse_autograd("fused_edge_transition",
                           [edge, node_bias, *p.values(), *(readout if readout is not None else ())])
    return _forward(edge, node_bias, node_mask, p, dtype, readout, ops, eps)


def fused_edge_transition_int8(edge, node_bias, node_mask, p: dict, dtype=torch.bfloat16,
                               readout: Optional[tuple] = None, ops: Optional[dict] = None,
                               eps: float = 1e-5):
    """The int8 serving profile's EdgeTransition forward (readout optional).
    Forward-only: it raises if grad mode is on and an input requires grad.
    CPU tensors run :func:`edge_transition_int8_plain`; CUDA tensors run the
    int8 kernel (K6), which takes the bf16 kernel's widths and raises on
    anything else. ``ops`` may carry ``kernel_operands(p, readout,
    quant_int8=True)`` made once."""
    native.refuse_autograd("fused_edge_transition_int8",
                           [edge, node_bias, *p.values(), *(readout if readout is not None else ())],
                           hint=INT8_HINT)
    if edge.device.type == "cpu":
        return edge_transition_int8_plain(edge, node_bias, node_mask, p, dtype, readout, eps)
    if ops is None:
        ops = kernel_operands(p, readout, quant_int8=True)
    return _launch("edge_transition_int8", _INT8_ARGTYPES, edge, node_bias, node_mask, dtype,
                   readout, ops, eps,
                   ("w1t", "b1", "w2qt", "w2s", "b2", "w3t", "w3qt", "w3s", "b3", "ln_scale",
                    "ln_bias"), ("wrt", "bro"))


def _forward(edge, node_bias, node_mask, p, dtype, readout=None, ops=None, eps=1e-5):
    if edge.device.type == "cpu":
        return edge_transition_plain(edge, node_bias, node_mask, p, dtype, readout, eps)
    cz = edge.shape[-1]
    check_widths(cz, node_bias.shape[-1], p["k1"].shape[1])
    if ops is None:
        ops = kernel_operands(p, readout)
    if cz != CZ:
        return _launch_wide(edge, node_bias, node_mask, dtype, readout, ops, eps)
    return _launch("edge_transition", _ARGTYPES, edge, node_bias, node_mask, dtype, readout, ops,
                   eps, ("w1t", "b1", "w2t", "b2", "w3t", "b3", "ln_scale", "ln_bias"),
                   ("wrt", "bro"))


def _launch(name, argtypes, edge, node_bias, node_mask, dtype, readout, ops, eps, weights,
            readout_weights):
    """Check what the forward kernels read and launch csrc/<name>.cu's
    ``<name>_forward`` with (edge, node_bias, mask, the `weights` of `ops`,
    the `readout_weights` of `ops` (null without a readout), outputs, B, L,
    n_b, n_pz, eps, stream): one launch."""
    if dtype != torch.bfloat16:
        raise ValueError(f"the EdgeTransition kernels compute in bfloat16, not {dtype}")
    B, L = edge.shape[:2]
    bf, f32 = torch.bfloat16, torch.float32
    native.check_tensor(edge, "edge", (B, L, L, CZ), bf)
    native.check_tensor(node_bias, "node_bias", (B, L, CZ), bf)
    _check_ops(ops, weights, _OPERANDS, "kernel_operands(p, readout, quant_int8=...)")
    mask = node_mask.to(f32).contiguous()
    native.check_tensor(mask, "node_mask", (B, L), f32)

    out = torch.empty(B, L, L, CZ, dtype=bf, device=edge.device)
    if readout is not None:
        if any(k not in ops for k in readout_weights):
            raise ValueError("readout requested but ops were made without it")
        _check_ops(ops, readout_weights, _OPERANDS, "kernel_operands(p, readout)")
        n_b, n_pz = ops["n_b"], ops["n_pz"]
        b_out = torch.empty(B, n_b, L, L, dtype=bf, device=edge.device)
        pz_out = torch.empty(B, n_pz, L, L, dtype=bf, device=edge.device)
        ro_ptrs = [ops[k].data_ptr() for k in readout_weights]
        out_ptrs = [b_out.data_ptr(), pz_out.data_ptr()]
    else:
        n_b = n_pz = 0
        ro_ptrs, out_ptrs = [None, None], [None, None]
    fn = native.function(name, f"{name}_forward", argtypes)
    ins = [edge, node_bias, mask] + [ops[k] for k in weights]
    ptrs = lambda ts: [t.data_ptr() for t in ts]
    rc = fn(*ptrs(ins), *ro_ptrs, out.data_ptr(), *out_ptrs, B, L, n_b, n_pz, eps,
            torch.cuda.current_stream(edge.device).cuda_stream)
    native.check(rc, name)
    native.count_launch(name)
    if readout is None:
        return out
    return out, b_out, pz_out


def _launch_wide(edge, node_bias, node_mask, dtype, readout, ops, eps):
    """K1/K2 at c_z 128, 256, 512: csrc/edge_transition.cu's
    ``edge_transition_wide_forward`` (six device launches with the readout,
    five without), counted as one launch of the kernel."""
    if dtype != torch.bfloat16:
        raise ValueError(f"the EdgeTransition kernels compute in bfloat16, not {dtype}")
    B, L, _, cz = edge.shape
    if B * L * L > 2**31 - 1:
        raise ValueError(f"B*L*L = {B * L * L} pairs: the kernels index pairs in 32 bits")
    hid, bf, f32, dev = 3 * cz, torch.bfloat16, torch.float32, edge.device
    native.check_tensor(edge, "edge", (B, L, L, cz), bf)
    native.check_tensor(node_bias, "node_bias", (B, L, cz), bf)
    lanes = ops["wrt"].shape[0] if readout is not None and "wrt" in ops else 0
    shapes = _wide_operands(cz, lanes)
    weights = ("wn", "w1t", "b1", "w2t", "b2", "w3t", "b3", "ln_scale", "ln_bias")
    _check_ops(ops, weights, shapes, "kernel_operands(p, readout)")
    mask = node_mask.to(f32).contiguous()
    native.check_tensor(mask, "node_mask", (B, L), f32)
    empty = lambda *s, dt=bf: torch.empty(*s, dtype=dt, device=dev)
    out = empty(B, L, L, cz)
    scratch = [empty(B * L, 2 * hid + 2 * cz, dt=f32), empty(B * L * L, hid),
               empty(B * L * L, hid), empty(B * L * L, cz, dt=f32)]
    if readout is not None:
        if "wrt" not in ops:
            raise ValueError("readout requested but ops were made without it")
        _check_ops(ops, ("wrt", "bro"), shapes, "kernel_operands(p, readout)")
        n_b, n_pz = ops["n_b"], ops["n_pz"]
        b_out, pz_out = empty(B, n_b, L, L), empty(B, n_pz, L, L)
        ro = [ops["wrt"].data_ptr(), ops["bro"].data_ptr()]
        outs = [out.data_ptr(), b_out.data_ptr(), pz_out.data_ptr()]
    else:
        n_b = n_pz = 0
        ro, outs = [None, None], [out.data_ptr(), None, None]
    fn = native.function("edge_transition", "edge_transition_wide_forward", _WIDE_ARGTYPES)
    ins = [edge, node_bias, mask] + [ops[k] for k in weights]
    rc = fn(*[t.data_ptr() for t in ins], *ro, *[t.data_ptr() for t in scratch], *outs, B, L, cz,
            n_b, n_pz, lanes, eps, torch.cuda.current_stream(dev).cuda_stream)
    native.check(rc, "edge_transition")
    native.count_launch("edge_transition")
    if readout is None:
        return out
    return out, b_out, pz_out


# ---------------------------------------------------------------- backward
def edge_transition_bwd_plain(edge, node_bias, node_mask, p: dict, g, dtype=torch.bfloat16,
                              eps: float = 1e-5):
    """The backward kernel's arithmetic in plain PyTorch, at the JAX
    kernel's rounding points (``pallas_edge_bwd._bwd_kernel``): the forward
    is recomputed with `dtype` GEMM operands, the residual r = h2 + [e |
    n_i | n_j] rounded as a whole before the last product, and do, da2, da1
    rounded to `dtype` before theirs; LayerNorm statistics and every sum are
    float32. Returns (d_edge, d_node_bias, {name: grad}), all float32."""
    cz, cb = edge.shape[-1], node_bias.shape[-1]
    B, L = edge.shape[:2]
    e = _round(edge, dtype)
    n = _round(node_bias, dtype)
    k1, k2, k3 = (_round(p[k], dtype) for k in ("k1", "k2", "k3"))
    x = torch.cat([e, n[:, :, None].expand(B, L, L, cb), n[:, None].expand(B, L, L, cb)], -1)
    a1 = x @ k1 + p["b1"].float()
    h1c = _round(torch.relu(a1), dtype)
    a2 = h1c @ k2 + p["b2"].float()
    rc = _round(torch.relu(a2) + x, dtype)
    o = rc @ k3 + p["b3"].float()
    mu = o.mean(-1, keepdim=True)
    inv = torch.rsqrt((o - mu).square().mean(-1, keepdim=True) + eps)
    y = (o - mu) * inv
    m = node_mask.float()
    g_out = g.float() * (m[:, :, None] * m[:, None, :])[..., None]
    dy = g_out * p["ln_scale"].float()
    do = (dy - dy.mean(-1, keepdim=True) - y * (dy * y).mean(-1, keepdim=True)) * inv
    doc = _round(do, dtype)
    dr = doc @ k3.t()
    da2 = dr * (a2 > 0)
    da2c = _round(da2, dtype)
    da1 = (da2c @ k2.t()) * (a1 > 0)
    da1c = _round(da1, dtype)
    dx = da1c @ k1.t() + dr
    flat = lambda t: t.reshape(-1, t.shape[-1])
    grads = {"k1": flat(x).t() @ flat(da1c), "b1": flat(da1).sum(0),
             "k2": flat(h1c).t() @ flat(da2c), "b2": flat(da2).sum(0),
             "k3": flat(rc).t() @ flat(doc), "b3": flat(do).sum(0),
             "ln_scale": flat(g_out * y).sum(0), "ln_bias": flat(g_out).sum(0)}
    d_node = dx[..., cz:cz + cb].sum(2) + dx[..., cz + cb:].sum(1)
    return dx[..., :cz], d_node, grads


def edge_transition_bwd(edge, node_bias, node_mask, p: dict, g, dtype=torch.bfloat16,
                        ops: Optional[dict] = None, eps: float = 1e-5, d_edge_dtype=None):
    """Gradients of the EdgeTransition (readout off) with respect to edge,
    node_bias and the parameters, for the cotangent `g` of its output.
    CPU tensors run :func:`edge_transition_bwd_plain`; CUDA tensors run the
    bf16 backward kernel (three launches at c_z 64, twenty from 128 on,
    counted as one call) or raise.
    Returns (d_edge in `d_edge_dtype` (bfloat16 or float32; float32 by
    default), d_node_bias float32, {name: float32 grad}). Two calls on the
    same inputs give bit-identical results: cross-block sums go through
    partials added in a fixed order, not atomics."""
    if edge.device.type == "cpu":
        d_edge, d_node, grads = edge_transition_bwd_plain(edge, node_bias, node_mask, p, g,
                                                          dtype, eps)
        return d_edge.to(d_edge_dtype or torch.float32), d_node, grads
    if dtype != torch.bfloat16:
        raise ValueError(f"the EdgeTransition backward kernel computes in bfloat16, not {dtype}")
    B, L = edge.shape[:2]
    if B * L * L > 2**31 - 1:
        raise ValueError(f"B*L*L = {B * L * L} pairs: the backward kernel indexes pairs in 32 bits")
    cz = edge.shape[-1]
    check_widths(cz, node_bias.shape[-1], p["k1"].shape[1])
    if ops is None:
        ops = kernel_operands(p)
    bf, f32 = torch.bfloat16, torch.float32
    d_edge_dtype = d_edge_dtype or f32
    if d_edge_dtype not in (bf, f32):
        raise ValueError(f"d_edge is written as bfloat16 or float32, not {d_edge_dtype}")
    dev = edge.device
    e = edge.to(bf).contiguous()
    nb = node_bias.to(bf).contiguous()
    gg = g.to(bf).contiguous()
    mask = node_mask.to(f32).contiguous()
    if cz != CZ:
        return _bwd_wide(e, nb, mask, gg, ops, d_edge_dtype, eps)
    native.check_tensor(e, "edge", (B, L, L, CZ), bf)
    native.check_tensor(nb, "node_bias", (B, L, CZ), bf)
    native.check_tensor(gg, "g", (B, L, L, CZ), bf)
    native.check_tensor(mask, "node_mask", (B, L), f32)
    weights = ("w1t", "b1", "w2t", "b2", "w3t", "b3", "ln_scale")
    _check_ops(ops, weights, _OPERANDS, "kernel_operands(p)")

    grid, (n1, n2, n3), ntiles, nbi = bwd_schedule(B, L, native.sm_count(dev))
    empty = lambda *s, dt=f32: torch.empty(*s, dtype=dt, device=dev)
    rows = ntiles * BWD_TI * BWD_TI
    scratch = {"h1": empty(rows, HID, dt=bf), "r": empty(rows, HID, dt=bf),
               "do": empty(rows, CZ, dt=bf), "da2": empty(rows, HID, dt=bf),
               "da1": empty(rows, HID, dt=bf), "vpart": empty(grid, VEC),
               "wpart": empty((n1 + n2) * HID * HID + n3 * HID * CZ),
               "rowpart": empty(B * L * nbi, CZ),
               "colpart": empty(B * L * BWD_COL_SLOTS * nbi, CZ)}
    d_edge = empty(B, L, L, CZ, dt=d_edge_dtype)
    d_node = empty(B, L, CZ)
    grads = {"k1": empty(HID, HID), "b1": empty(HID), "k2": empty(HID, HID), "b2": empty(HID),
             "k3": empty(HID, CZ), "b3": empty(CZ), "ln_scale": empty(CZ), "ln_bias": empty(CZ)}
    fn = native.function("edge_transition_bwd", "edge_transition_backward", _BWD_ARGTYPES)
    ins = [e, nb, mask, gg] + [ops[k] for k in weights]
    outs = list(scratch.values()) + [d_edge, d_node] + [grads[k] for k in PARAM_NAMES]
    rc = fn(*[t.data_ptr() for t in ins + outs], B, L, grid, n1, n2, n3,
            int(d_edge_dtype == f32), eps, torch.cuda.current_stream(dev).cuda_stream)
    native.check(rc, "edge_transition_bwd")
    native.count_launch("edge_transition_bwd")
    return d_edge, d_node, grads


def _bwd_wide(e, nb, mask, gg, ops, d_edge_dtype, eps):
    """K4 at c_z 128, 256, 512: csrc/edge_transition_bwd.cu's
    ``edge_transition_wide_backward`` (twenty device launches), counted as
    one launch of the kernel."""
    B, L, _, cz = e.shape
    hid, M, bf, f32, dev = 3 * cz, B * L * L, torch.bfloat16, torch.float32, e.device
    for name, t, shape in (("edge", e, (B, L, L, cz)), ("node_bias", nb, (B, L, cz)),
                           ("g", gg, (B, L, L, cz))):
        native.check_tensor(t, name, shape, bf)
    native.check_tensor(mask, "node_mask", (B, L), f32)
    weights = ("wn", "w1t", "b1", "w2t", "b2", "w3t", "b3", "ln_scale", "k1b", "k2b", "k3b")
    _check_ops(ops, weights, _wide_operands(cz), "kernel_operands(p)")
    ks = wide_bwd_schedule(M, cz, native.sm_count(dev))
    nblk = -(-M // WIDE_ROWS)
    empty = lambda *s, dt=f32: torch.empty(*s, dtype=dt, device=dev)
    scratch = [empty(B * L, 2 * hid), empty(M, hid, dt=bf), empty(M, hid, dt=bf),
               empty(M, hid, dt=torch.uint8), empty(M, cz), empty(M, cz, dt=bf),
               empty(M, hid, dt=bf), empty(M, hid, dt=bf), empty(M, 2 * cz), empty(nblk, 3 * cz),
               empty(nblk, hid), empty(nblk, hid), empty(-(-M // ks[0]), hid, hid),
               empty(-(-M // ks[1]), hid, hid), empty(-(-M // ks[2]), hid, cz)]
    d_edge = empty(B, L, L, cz, dt=d_edge_dtype)
    d_node = empty(B, L, cz)
    grads = {"k1": empty(hid, hid), "b1": empty(hid), "k2": empty(hid, hid), "b2": empty(hid),
             "k3": empty(hid, cz), "b3": empty(cz), "ln_scale": empty(cz), "ln_bias": empty(cz)}
    fn = native.function("edge_transition_bwd", "edge_transition_wide_backward",
                         _WIDE_BWD_ARGTYPES)
    ins = [e, nb, mask, gg] + [ops[k] for k in weights]
    outs = scratch + [d_edge, d_node] + [grads[k] for k in PARAM_NAMES]
    rc = fn(*[t.data_ptr() for t in ins + outs], B, L, cz, *ks, int(d_edge_dtype == f32), eps,
            torch.cuda.current_stream(dev).cuda_stream)
    native.check(rc, "edge_transition_bwd")
    native.count_launch("edge_transition_bwd")
    return d_edge, d_node, grads


def wide_kslice(K: int, rows: int, cols: int, sms: int, rows_tile: int = 128) -> int:
    """Pairs a K slice of a wide weight-gradient GEMM (rows x cols summed
    over K pairs) takes: enough slices that about two blocks an SM run
    (rows/128 x cols/128 tiles a slice), at most 64, each a multiple of 64
    pairs (the GEMM's K tile). The fp32 partial slots, rows x cols each,
    then number at most about 2 x sms / tiles: ~17 MB at every width on a
    132-SM card."""
    tiles = -(-rows // rows_tile) * -(-cols // 128)
    slices = max(1, min(64, -(-2 * sms // tiles), -(-K // 64)))
    per = -(-K // slices)
    return -(-per // 64) * 64


def wide_bwd_schedule(M: int, cz: int, sms: int):
    """(ks1, ks2, ks3): the K slices of the wide backward's dW1 (3 c_z x 3
    c_z), dW2 (3 c_z x 3 c_z) and dW3 (3 c_z x c_z) over M pairs."""
    hid = 3 * cz
    return (wide_kslice(M, hid, hid, sms), wide_kslice(M, hid, hid, sms),
            wide_kslice(M, hid, cz, sms))


def bwd_schedule(B: int, L: int, sms: int):
    """How the backward kernel splits its work on a card of `sms` SMs:
    (the chain kernel's grid, the weight kernel's chunks of tiles (n1, n2,
    n3) for dW1, dW2, dW3, the number of 8 x 8 tiles, tiles a side of a
    batch row). The chain kernel runs two warpgroups a block, one tile
    each at a time; the weight kernel one block a chunk, in proportion
    2 : 3 : 2 to the bytes each reads a tile (dW2 reads two 192-wide
    images, dW1 one and the edge rows of its gathered C, dW3 one and a
    64-wide one)."""
    nbi = -(-L // BWD_TI)
    ntiles = B * nbi * nbi
    grid = max(1, min(sms, -(-ntiles // 2)))
    u = max(1, sms // 7)
    n1, n2, n3 = (max(1, min(k * u, ntiles)) for k in (2, 3, 2))
    return grid, (n1, n2, n3), ntiles, nbi


class EdgeTransitionFn(torch.autograd.Function):
    """EdgeTransition (readout off) under autograd, the counterpart of
    ``fused_edge_transition_vjp``: the forward runs the forward kernel and
    saves only its inputs; the backward runs the backward kernel and returns
    d_edge (in edge's dtype), d_node_bias (in node_bias's dtype) and the
    eight parameter gradients (float32). The parameters are inputs, so their
    ``.grad`` fills; ``ops`` are only the kernels' bf16 copies of them. On
    the CPU both directions take their plain versions.

    apply(edge, node_bias, node_mask, k1, b1, k2, b2, k3, b3, ln_scale,
    ln_bias, dtype, ops)"""

    @staticmethod
    def forward(ctx, edge, node_bias, node_mask, *rest):
        params, (dtype, ops) = rest[:8], rest[8:]
        p = dict(zip(PARAM_NAMES, params))
        ctx.save_for_backward(edge, node_bias, node_mask, *params)
        ctx.dtype, ctx.ops = dtype, ops
        if edge.device.type == "cuda":
            edge, node_bias = edge.to(dtype).contiguous(), node_bias.to(dtype).contiguous()
        return _forward(edge, node_bias, node_mask, p, dtype, None, ops)

    @staticmethod
    def backward(ctx, g):
        edge, node_bias, node_mask, *params = ctx.saved_tensors
        p = dict(zip(PARAM_NAMES, params))
        d_edge, d_node, grads = edge_transition_bwd(edge, node_bias, node_mask, p, g.contiguous(),
                                                    ctx.dtype, ops=ctx.ops,
                                                    d_edge_dtype=edge.dtype)
        return (d_edge.to(edge.dtype), d_node.to(node_bias.dtype), None,
                *(grads[k].to(prm.dtype) for k, prm in zip(PARAM_NAMES, params)), None, None)
