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
:data:`INT8_K_PERM`. From c_z 128 on it is the wide design
(csrc/edge_transition_int8.cu ``edge_transition_int8_wide_forward``, on
csrc/edge_wide.cuh), whose int8 weights are unpermuted.

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
run the node pre-pass and one tile kernel of csrc/edge_wide.cuh (warp
specialised, its weights streamed through a ring in shared memory in the
stages :func:`wide_stages` lists, packed once by :func:`kernel_operands`).
Any other width raises (:func:`check_widths`). The int8 kernel (K6) takes
the same widths.

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
# edge_transition_wide_forward: 17 pointers, B, L, cz, n_b, n_pz, ro_pad, the bytes of wb
# and wrb, eps, stream.
_WIDE_ARGTYPES = ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 2
                  + [ctypes.c_float, ctypes.c_void_p])
# edge_transition_int8_wide_forward: 19 pointers, then as edge_transition_wide_forward.
_INT8_WIDE_ARGTYPES = ([ctypes.c_void_p] * 19 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 2
                       + [ctypes.c_float, ctypes.c_void_p])
# edge_transition_wide_backward: 31 pointers, B, L, cz, grid, nslices, the bytes of wbb, the
# floats of the reduction's partials, its tickets, d_edge_f32, eps, stream.
_WIDE_BWD_ARGTYPES = ([ctypes.c_void_p] * 31 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 2
                      + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_void_p])
RK_CHUNK = 512   # K of a chunk of the wide backward's reduction (edge_transition_bwd.cu)
PIECE = 64 * 128     # bytes of a wide forward's weight piece: 64 rows x 128 bytes of K
STAGE = 2 * PIECE    # a ring stage: consumer warpgroup 0's piece, then warpgroup 1's
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
    """q . wq of int8 values, the int32 sum rounded to float32 as the
    kernels' (and the JAX kernel's) conversion rounds it: a float64 matmul
    of the integers is exact at every hidden width (|sum| <= 1536 * 127 *
    127 < 2^53; a float32 one would be exact only below 2^24, which the 8x
    hidden width of 1536 passes at 24.8 M)."""
    return (q.double() @ wq.double()).float()


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


# ---------------------------------------------------------------- wide stages
def wide_pieces(wt: torch.Tensor) -> torch.Tensor:
    """The 8 KB pieces of a K-major weight wt [N][K] (bf16 or int8; N a
    multiple of 64, K a multiple of 128 bytes) as the wide tile kernel reads
    them: piece (n, k) holds rows 64n .. 64n + 63, bytes 128k .. 128k + 127
    of each, in the 128-byte swizzled layout of csrc/wgmma.cuh (16-byte
    chunk c of row r at chunk c ^ (r % 8)). Returns [N / 64][K bytes / 128]
    [8192] uint8."""
    u8 = wt.contiguous().view(torch.uint8)
    n, kb = u8.shape
    t = u8.reshape(n // 64, 64, kb // 128, 8, 16).permute(0, 2, 1, 3, 4)
    r = torch.arange(64, device=wt.device).reshape(64, 1)
    src = torch.arange(8, device=wt.device).reshape(1, 8) ^ (r % 8)
    idx = src.reshape(1, 1, 64, 8, 1).expand(n // 64, kb // 128, 64, 8, 16)
    return torch.gather(t, 3, idx).reshape(n // 64, kb // 128, PIECE)


def wide_stages(cz: int, quant_int8: bool = False) -> list:
    """The stages of the wide tile kernel's weight ring, every tile the same,
    in the order its consumers take them (csrc/edge_wide.cuh): (weight,
    (64-row block of consumer warpgroup 0, that of warpgroup 1), K panel).
    Layer 1 ("w1e", e's rows of k1), chunk by chunk of 128 hidden columns
    (64 a warpgroup; for int8 from c_z 256 on twice: the amax pass, then
    the quantizing one). bf16: o = e.W3e ("w3e"), each warpgroup its half of
    o's 64-column blocks; then for each 128-column chunk of h2 its W2 pieces
    ("w2", K = the hidden width in panels of 64) and the W3 pieces of o's
    blocks over the chunk's two panels ("w3"). int8: q1.W2q chunk by chunk
    ("w2q", K in panels of 128 int8), then for each block of o its e.W3e
    and its q2.W3q ("w3q")."""
    hid, nj, ke = 3 * cz, cz // 128, cz // 64
    nc = hid // 128
    l1 = [("w1e", (2 * c, 2 * c + 1), k) for c in range(nc) for k in range(ke)]
    o = lambda j: [("w3e", (j, nj + j), k) for k in range(ke)]
    if quant_int8:
        kh = hid // 128
        stages = l1 * (1 if cz == 128 else 2)
        stages += [("w2q", (2 * c, 2 * c + 1), k) for c in range(nc) for k in range(kh)]
        for j in range(nj):
            stages += o(j) + [("w3q", (j, nj + j), k) for k in range(kh)]
        return stages
    stages = l1 + [st for j in range(nj) for st in o(j)]
    for c in range(nc):
        stages += [("w2", (2 * c, 2 * c + 1), k) for k in range(hid // 64)]
        stages += [("w3", (j, nj + j), 2 * c + k) for j in range(nj) for k in range(2)]
    return stages


WIDE_BWD_STREAM_CZ = 512   # from this c_z the backward's h1, r and da2 round-trip (A pieces)


def wide_bwd_stages(cz: int) -> list:
    """The stages of the wide backward's chain kernel (csrc/edge_transition_bwd.cu
    ``ebwd::Chain``), every tile the same, in the order its consumers take
    them, as :func:`wide_stages` lists the forward's: a1 = e.W1e ("w1e")
    chunk by chunk of 128 hidden columns; for each chunk of a2 its W2 pieces
    ("w2", K the hidden width) and the W3 pieces of o's blocks over the
    chunk's two panels ("w3"); dr = do.W3^T ("k3": k3 as stored, [hid][cz],
    K-major for this product) chunk by chunk; the d_edge init do.W3e^T (k3's
    first c_z rows); for each chunk of dh1 its W2^T pieces ("k2": k2 as
    stored) and the W1e^T pieces of d_edge's blocks ("k1e": k1's first c_z
    rows as stored). At c_z 512 (WIDE_BWD_STREAM_CZ) every chunk's W2 pieces
    come first, then each block of o's W3 pieces over the hidden width; and
    after dr every chunk's W2^T pieces, then for each block of d_edge its
    init's and its W1e^T pieces over the hidden width."""
    hid, nj, ke, kh = 3 * cz, cz // 128, cz // 64, 3 * cz // 64
    nc = hid // 128
    hidden = lambda a, b: [st for c in range(nc)
                           for st in [(a, (2 * c, 2 * c + 1), k) for k in range(kh)]
                           + [(b, (j, nj + j), 2 * c + k) for j in range(nj) for k in range(2)]]
    a1 = [("w1e", (2 * c, 2 * c + 1), k) for c in range(nc) for k in range(ke)]
    dr = [("k3", (2 * c, 2 * c + 1), k) for c in range(nc) for k in range(ke)]
    d_init = lambda j: [("k3", (j, nj + j), k) for k in range(ke)]
    if cz >= WIDE_BWD_STREAM_CZ:
        every = lambda a: [(a, (2 * c, 2 * c + 1), k) for c in range(nc) for k in range(kh)]
        by_block = lambda b, j: [(b, (j, nj + j), k) for k in range(kh)]
        return (a1 + every("w2") + [st for j in range(nj) for st in by_block("w3", j)] + dr
                + every("k2") + [st for j in range(nj) for st in d_init(j) + by_block("k1e", j)])
    return (a1 + hidden("w2", "w3") + dr + [st for j in range(nj) for st in d_init(j)]
            + hidden("k2", "k1e"))


def readout_stages(cz: int, lanes: int) -> list:
    """The readout's stages ("wr", the padded [kb | kdz | 0] transposed):
    pairs of 64-lane blocks (the second may lie past `lanes`: zeros), each
    over the c_z / 64 panels of out."""
    return [("wr", (2 * p, 2 * p + 1), k) for p in range(-(-lanes // 128))
            for k in range(cz // 64)]


_STAGE_ROWS: dict = {}   # (stage list, piece grid, device) -> the rows _pack_stages gathers


def _pack_stages(stages, pieces: dict) -> torch.Tensor:
    """The stages' images, one after another: [len(stages) * STAGE] uint8,
    gathered at once from every piece (and a zero piece for blocks past a
    weight's rows): the training step rebuilds them after each update. The
    gather's rows are made once per layout and device (a copy to the device
    would wait for the work queued before it)."""
    dev = next(iter(pieces.values())).device
    grid = tuple((name, p.shape[0], p.shape[1]) for name, p in pieces.items())
    key = (tuple(stages), grid, dev)
    rows = _STAGE_ROWS.get(key)
    if rows is None:
        start, row = {}, 0
        for name, n_rows, n_k in grid:
            start[name] = row
            row += n_rows * n_k
        n_k = {name: k for name, _, k in grid}
        n_rows = {name: r for name, r, _ in grid}
        rows = torch.tensor([start[w] + n * n_k[w] + k if n < n_rows[w] else row
                             for w, blocks, k in stages for n in blocks], device=dev)
        _STAGE_ROWS[key] = rows
    flat = torch.cat([p.reshape(-1, PIECE) for p in pieces.values()]
                     + [torch.zeros(1, PIECE, dtype=torch.uint8, device=dev)])
    return flat[rows].reshape(-1)


# ---------------------------------------------------------------- kernels
def check_widths(cz: int, cb: int, hid: int, n_ro: Optional[int] = None,
                 quant_int8: bool = False) -> None:
    """Raise unless the kernels take these widths: c_z 64 (the flagship
    kernels) or 128, 256, 512 (the wide ones), a c_z-wide node bias, hidden
    3 c_z, and with a readout at most 32 lanes at c_z 64 and 8 + c_z/4 from
    128 on (the next block's heads and down_z channels); the int8 kernel
    (`quant_int8`) takes the same widths."""
    if cz != CZ and cz not in WIDE_CZ:
        raise ValueError(f"c_z = {cz} is not supported by the EdgeTransition kernels (64, 128, "
                         "256 or 512)")
    if cb != cz or hid != 3 * cz:
        raise ValueError(f"node bias {cb} and hidden {hid} wide at c_z = {cz}: the EdgeTransition "
                         f"kernels take a node bias of c_z and a hidden width of 3 c_z = {3 * cz}")
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
    readout padded to a multiple of 64 lanes, wrt (lanes, c_z); the int8
    weights w2qt, w3qt are not permuted there. The forward's tile kernel
    reads its weights as wb, the stages of :func:`wide_stages` packed one
    after another (16 KB each), and wrb those of :func:`readout_stages`; the
    backward's chain kernel as wbb, those of :func:`wide_bwd_stages` (not
    with `quant_int8`, which is forward-only). Unsupported widths raise
    (:func:`check_widths`)."""
    bf = torch.bfloat16
    cz, cb, hid = _param_widths(p)
    n_ro = None if readout is None else readout[0].shape[1] + readout[2].shape[1]
    check_widths(cz, cb, hid, n_ro, quant_int8)
    ops = {k: p[k].float().contiguous() for k in ("b1", "b2", "b3", "ln_scale", "ln_bias")}
    if quant_int8:
        ops.update({f"w{k}t": p[f"k{k}"].to(bf).t().contiguous() for k in ("1", "3")})
        for k in ("2", "3"):
            q, scale = quant_cols(p[f"k{k}"])
            qt = q.t()[:, INT8_K_PERM.to(q.device)] if cz == CZ else q.t()
            ops.update({f"w{k}qt": qt.contiguous(), f"w{k}s": scale.reshape(-1).contiguous()})
    else:
        ops.update({f"w{k}t": p[f"k{k}"].to(bf).t().contiguous() for k in ("1", "2", "3")})
    if cz != CZ:
        k1, k3 = p["k1"].to(bf), p["k3"].to(bf)
        ops["wn"] = torch.cat([k1[cz:2 * cz].t(), k1[2 * cz:].t(), k3[cz:2 * cz].t(),
                               k3[2 * cz:].t()]).contiguous()
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
    if cz != CZ:
        pieces = {"w1e": wide_pieces(ops["w1t"][:, :cz]), "w3e": wide_pieces(ops["w3t"][:, :cz])}
        if quant_int8:
            pieces.update(w2q=wide_pieces(ops["w2qt"]), w3q=wide_pieces(ops["w3qt"]))
        else:
            pieces.update(w2=wide_pieces(ops["w2t"]), w3=wide_pieces(ops["w3t"]))
        ops["wb"] = _pack_stages(wide_stages(cz, quant_int8), pieces)
        if not quant_int8:
            k1, k2, k3 = (p[f"k{k}"].to(bf) for k in ("1", "2", "3"))
            pieces.update(k3=wide_pieces(k3), k2=wide_pieces(k2), k1e=wide_pieces(k1[:cz]))
            ops["wbb"] = _pack_stages(wide_bwd_stages(cz), pieces)
        if readout is not None:
            ops["wrb"] = _pack_stages(readout_stages(cz, ops["wrt"].shape[0]),
                                      {"wr": wide_pieces(ops["wrt"])})
    return ops


def _wide_operands(cz: int, lanes: int = 0, quant_int8: bool = False) -> dict:
    """What the wide kernels read of their operands at c_z = cz: name ->
    (shape, dtype)."""
    hid, bf, f32, u8 = 3 * cz, torch.bfloat16, torch.float32, torch.uint8
    return {"wb": ((len(wide_stages(cz, quant_int8)) * STAGE,), u8),
            "wbb": ((len(wide_bwd_stages(cz)) * STAGE,), u8),
            "wrb": ((len(readout_stages(cz, lanes)) * STAGE,), u8),
            "b1": ((hid,), f32), "b2": ((hid,), f32), "b3": ((cz,), f32),
            "ln_scale": ((cz,), f32), "ln_bias": ((cz,), f32),
            "w1t": ((hid, hid), bf), "w2t": ((hid, hid), bf), "w3t": ((cz, hid), bf),
            "wn": ((2 * hid + 2 * cz, cz), bf),
            "wrt": ((lanes, cz), bf), "bro": ((lanes,), f32),
            "w2qt": ((hid, hid), torch.int8), "w2s": ((hid,), f32),
            "w3qt": ((cz, hid), torch.int8), "w3s": ((cz,), f32)}


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
    cz = edge.shape[-1]
    check_widths(cz, node_bias.shape[-1], p["k1"].shape[1], quant_int8=True)
    if ops is None:
        ops = kernel_operands(p, readout, quant_int8=True)
    if cz != CZ:
        return _launch_wide(edge, node_bias, node_mask, dtype, readout, ops, eps, quant_int8=True)
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


def _launch_wide(edge, node_bias, node_mask, dtype, readout, ops, eps, quant_int8=False):
    """K1/K2 at c_z 128, 256, 512: csrc/edge_transition.cu's
    ``edge_transition_wide_forward``; with `quant_int8`, K6:
    csrc/edge_transition_int8.cu's ``edge_transition_int8_wide_forward``:
    two device launches a call (the node pre-pass and the tile kernel),
    counted as one launch of the kernel. Scratch: the node terms y (B L, 8
    c_z) fp32 and what ``*_wide_scratch_bytes`` asks for (64-row slots of
    the hidden rows that round-trip: bf16 h1 at c_z 512, int8's fp32 h2 at
    256 and 512; none otherwise). The library refuses weight stages
    (``ops["wb"]``, ``ops["wrb"]``) of another length than its schedule
    reads."""
    if dtype != torch.bfloat16:
        raise ValueError(f"the EdgeTransition kernels compute in bfloat16, not {dtype}")
    B, L, _, cz = edge.shape
    if B * L * L > 2**31 - 1:
        raise ValueError(f"B*L*L = {B * L * L} pairs: the kernels index pairs in 32 bits")
    bf, f32, dev = torch.bfloat16, torch.float32, edge.device
    native.check_tensor(edge, "edge", (B, L, L, cz), bf)
    native.check_tensor(node_bias, "node_bias", (B, L, cz), bf)
    lanes = ops["wrt"].shape[0] if readout is not None and "wrt" in ops else 0
    shapes = _wide_operands(cz, lanes, quant_int8)
    if quant_int8:
        name, argtypes = "edge_transition_int8", _INT8_WIDE_ARGTYPES
        weights = ("wn", "wb", "b1", "w2s", "b2", "w3s", "b3", "ln_scale", "ln_bias")
    else:
        name, argtypes = "edge_transition", _WIDE_ARGTYPES
        weights = ("wn", "wb", "b1", "b2", "b3", "ln_scale", "ln_bias")
    _check_ops(ops, weights, shapes, f"kernel_operands(p, readout, quant_int8={quant_int8})")
    mask = node_mask.to(f32).contiguous()
    native.check_tensor(mask, "node_mask", (B, L), f32)
    empty = lambda *s, dt=bf: torch.empty(*s, dtype=dt, device=dev)
    out = empty(B, L, L, cz)
    nbytes = native.function(name, f"{name}_wide_scratch_bytes", [ctypes.c_int] * 3)(cz, B, L)
    if nbytes < 0:
        raise RuntimeError(f"{name}: the device's SM count could not be read")
    y = empty(B * L, 8 * cz, dt=f32)
    scratch = empty(nbytes, dt=torch.uint8) if nbytes else None
    if readout is not None:
        if "wrb" not in ops:
            raise ValueError("readout requested but ops were made without it")
        _check_ops(ops, ("wrb", "bro"), shapes, "kernel_operands(p, readout)")
        n_b, n_pz = ops["n_b"], ops["n_pz"]
        b_out, pz_out = empty(B, n_b, L, L), empty(B, n_pz, L, L)
        ro, bro, outs = ops["wrb"].data_ptr(), ops["bro"].data_ptr(), [b_out.data_ptr(),
                                                                      pz_out.data_ptr()]
        ro_bytes = ops["wrb"].numel()
    else:
        n_b = n_pz = ro_bytes = 0
        ro, bro, outs = None, None, [None, None]
    fn = native.function(name, f"{name}_wide_forward", argtypes)
    ptrs = [t.data_ptr() for t in [edge, node_bias, mask, ops["wn"], ops["wb"]]]
    vecs = [ops[k].data_ptr() for k in weights[2:]]
    rc = fn(*ptrs, ro, *vecs, bro, y.data_ptr(), None if scratch is None else scratch.data_ptr(),
            out.data_ptr(), *outs, B, L, cz, n_b, n_pz, lanes, ops["wb"].numel(), ro_bytes, eps,
            torch.cuda.current_stream(dev).cuda_stream)
    native.check(rc, name)
    native.count_launch(name)
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
    bf16 backward kernel (three launches at c_z 64, four from 128 on,
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
    ``edge_transition_wide_backward`` (four device launches: the node
    pre-pass, the chain, weight-gradient and reduction kernels), counted as
    one launch of the kernel. Scratch (:func:`wide_bwd_scratch`): the node
    terms, the bf16 images of h1, r, da2, da1 and do that the weight pass
    reads, the per-residue sums and the fixed-order partials. The library
    refuses weight stages (``ops["wbb"]``) of another length than its
    schedule reads."""
    B, L, _, cz = e.shape
    hid, bf, f32, dev = 3 * cz, torch.bfloat16, torch.float32, e.device
    for name, t, shape in (("edge", e, (B, L, L, cz)), ("node_bias", nb, (B, L, cz)),
                           ("g", gg, (B, L, L, cz))):
        native.check_tensor(t, name, shape, bf)
    native.check_tensor(mask, "node_mask", (B, L), f32)
    weights = ("wn", "wbb", "b1", "b2", "b3", "ln_scale")
    _check_ops(ops, weights, _wide_operands(cz), "kernel_operands(p)")
    grid, nslices = wide_bwd_schedule(B, L, cz, native.sm_count(dev))
    scratch = [torch.empty(n, dtype=dt, device=dev)
               for n, dt in wide_bwd_scratch(B, L, cz, grid, nslices)]
    empty = lambda *s, dt=f32: torch.empty(*s, dtype=dt, device=dev)
    d_edge = empty(B, L, L, cz, dt=d_edge_dtype)
    d_node = empty(B, L, cz)
    grads = {"k1": empty(hid, hid), "b1": empty(hid), "k2": empty(hid, hid), "b2": empty(hid),
             "k3": empty(hid, cz), "b3": empty(cz), "ln_scale": empty(cz), "ln_bias": empty(cz)}
    fn = native.function("edge_transition_bwd", "edge_transition_wide_backward",
                         _WIDE_BWD_ARGTYPES)
    ins = [e, nb, mask, gg] + [ops[k] for k in weights]
    outs = scratch + [d_edge, d_node] + [grads[k] for k in PARAM_NAMES]
    rc = fn(*[t.data_ptr() for t in ins + outs], B, L, cz, grid, nslices, ops["wbb"].numel(),
            scratch[-2].numel(), scratch[-1].numel(), int(d_edge_dtype == f32), eps,
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


def wide_bwd_schedule(B: int, L: int, cz: int, sms: int):
    """(grid, nslices) of the wide backward on a card of `sms` SMs: the
    chain kernel's persistent grid (one block an SM, at most one a 64-pair
    tile) and the K slices of its weight gradients. A slice is dW1e, dW2
    and dW3 cut in 128 x 192 tiles (2 (c_z / 128) (hid / 192) + (hid / 128)
    (hid / 192) of them): enough slices for about two blocks an SM, at most
    one a tile, each with a [2 c_z hid + hid^2] fp32 slot, so the slots stay
    under ~28 MB at every width (3.0 to 15.7 MB a slice at c_z 128 to
    512)."""
    hid, ntiles = 3 * cz, -(-B * L * L // 64)
    tiles = 2 * (cz // 128) * (hid // 192) + (hid // 128) * (hid // 192)
    return max(1, min(sms, ntiles)), max(1, min(ntiles, round(2 * sms / tiles)))


def wide_bwd_scratch(B: int, L: int, cz: int, grid: int, nslices: int) -> list:
    """The wide backward's scratch, in the order its entry point takes it:
    [(elements, dtype)] of y (the node terms Y1_i | Y1_j, fp32), the tiles'
    bf16 images of h1, r, da2, da1 (hid wide) and do (c_z wide), 64 rows a
    tile, the per-residue sums [S_i | S_j | T_i | T_j] (fp32), the chain
    kernel's column sums a block, the weight gradients' slots (fp32), and
    the reduction's split tiles: their partials (fp32) and tickets (int32).
    The reduction cuts d_node (64 x 64 tiles, K = 8 c_z) and dW1's node rows
    (2 sides of 64 x 64 tiles, K = B L) in chunks of RK_CHUNK; a tile of P >
    1 chunks keeps P partial tiles (the library checks these sizes)."""
    hid, rows, BL = 3 * cz, -(-B * L * L // 64) * 64, B * L
    bf, f32 = torch.bfloat16, torch.float32
    t_dn, p_dn = -(-BL // 64) * (cz // 64), -(-8 * cz // RK_CHUNK)
    t_dw, p_dw = 2 * (cz // 64) * (hid // 64), -(-BL // RK_CHUNK)
    partials = (t_dn * p_dn if p_dn > 1 else 0) * 4096 + (t_dw * p_dw if p_dw > 1 else 0) * 4096
    return ([(BL * 2 * hid, f32)] + [(rows * hid, bf)] * 4 + [(rows * cz, bf),
            (BL * 2 * (hid + cz), f32), (grid * (2 * hid + 3 * cz), f32),
            (nslices * (2 * cz * hid + hid * hid), f32), (partials, f32),
            (t_dn + t_dw, torch.int32)])


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
