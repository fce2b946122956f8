"""Least times of the repository's kernels on one NVIDIA H100 SXM, computed
from the shapes: for each kernel, the larger of the bytes it must move (each
input read once, each output written once) over the memory rate and the
operations it does over the card's peak rate for their type; the tensor
cores and the fp32 units overlap, so the larger of their times counts.
Every one of K1–K9 is ported; ``chip_smoke.py`` prints each bound beside
its kernel's measured time.

    python -m pepflowww_torch.bounds

prints the table at the shapes each kernel runs at (computed, not measured;
no card needed).
"""

from __future__ import annotations

# Published H100 SXM peaks (NVIDIA data sheet, dense, at 700 W).
PEAK_BF16_TC = 989e12      # FLOP/s, bf16 tensor cores
PEAK_INT8_TC = 1979e12     # OP/s, int8 tensor cores
PEAK_FP32 = 67e12          # FLOP/s, fp32 outside the tensor cores
PEAK_HBM = 3.35e12         # bytes/s


def edge_bound_ms(B: int, L: int, cz=64, hid=192, cb=64, n_ro=24):
    """(ms, bound_by): least time for one EdgeTransition with the readout epilogue.
    Tensor cores: the bf16 MACs per pair (edge.W1e, W2, W3, edge.W3e,
    readout) and per residue (node.W1i, node.W1j, node.W3i, node.W3j).
    fp32 units: per pair the bias adds and ReLUs of both hidden layers, the
    node terms of layers 1 and 3 and b3, LayerNorm (7 ops a channel), the
    pair mask and the readout bias. Each input read / output written once."""
    pairs, nodes = B * L * L, B * L
    mac_pair = cz * hid + hid * hid + hid * cz + cz * cz + cz * n_ro
    mac_node = cb * (2 * hid + 2 * cz)
    t_tc = 2 * (mac_pair * pairs + mac_node * nodes) / PEAK_BF16_TC
    fp32_pair = 4 * hid + 2 * hid + 3 * cz + 7 * cz + cz + n_ro
    t_fp32 = fp32_pair * pairs / PEAK_FP32
    weights = 2 * (hid * hid * 2 + hid * cz + cz * n_ro) + 4 * (2 * hid + 4 * cz + n_ro)
    nbytes = pairs * (2 * cz + 2 * cz + 2 * n_ro) + nodes * (2 * cb + 4) + weights
    return _bound(max(t_tc, t_fp32), nbytes)


def _bound(t_ops: float, nbytes: float):
    """(ms, "operations" or "bytes"): the larger of the two least times. `t_ops`
    is already the larger of the per-unit times, since the units overlap."""
    t_bytes = nbytes / PEAK_HBM
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def dist_bound_ms(B: int, L: int, f=64, a2=225, n_pair_types=484):
    """(ms, bound_by): least time for the distance block. Tensor cores: the
    225->64->64 MLP in bf16. fp32 units: softplus (4 ops incl. exp and
    log1p) once per table entry, since a coefficient depends on the entry
    alone; per atom pair d2 (8 ops), the gaussian (2 ops incl. exp) and the
    masks (2 ops); per pair both bias adds and ReLUs and the pair mask. Each
    input read / output written once."""
    pairs, nodes = B * L * L, B * L
    t_tc = 2 * (a2 * f + f * f) * pairs / PEAK_BF16_TC
    t_fp32 = (4 * n_pair_types * a2 + (12 * a2 + 4 * f + f + 1) * pairs) / PEAK_FP32
    nbytes = (nodes * (15 * 3 * 4 + 15 * 4 + 4 + 4) + n_pair_types * a2 * 4
              + 2 * (a2 * f + f * f) + 8 * f + pairs * f * 2)
    return _bound(max(t_tc, t_fp32), nbytes)


def edge_bwd_bound_ms(B: int, L: int, cz=64, hid=192, cb=64):
    """(ms, bound_by): least time for the EdgeTransition backward. Tensor
    cores, per pair: the recompute (e.W1e, h1.W2, r.W3: 61,440 MAC) and the
    backward products (do.W3^T, dW3, da2.W2^T, dW2, da1.W1e^T, dW1e:
    122,880 MAC); per residue the node products of the recompute (64x512),
    d_node (512x64) and dW1's node rows (2x64x192). fp32 units, per pair:
    LayerNorm forward and backward (15 ops a channel), both hidden layers'
    bias, ReLU and mask forward and backward (6 ops a lane), the residual
    and the bias and LayerNorm-parameter sums. Bytes: edge and g in, d_edge
    out (bf16), node in, d_node out (fp32), weights and their gradients."""
    pairs, nodes = B * L * L, B * L
    mac_pair = cz * hid + hid * hid + hid * cz + 2 * (hid * cz) + 2 * (hid * hid) + 2 * (cz * hid)
    mac_node = cb * (2 * hid + 2 * cz) + (2 * hid + 2 * cz) * cb + 2 * cb * hid
    t_tc = 2 * (mac_pair * pairs + mac_node * nodes) / PEAK_BF16_TC
    t_fp32 = (15 * cz + 6 * 2 * hid + hid + 2 * hid + 3 * cz) * pairs / PEAK_FP32
    w = hid * hid * 2 + hid * cz
    nbytes = pairs * 3 * 2 * cz + nodes * (2 * cb + 4 * cb + 4) + 2 * w + 4 * w + 4 * 6 * hid
    return _bound(max(t_tc, t_fp32), nbytes)


def dist_bwd_bound_ms(B: int, L: int, f=64, a2=225, n_pair_types=484):
    """(ms, bound_by): least time for the distance backward. Tensor cores,
    per pair: the recompute (x.K1, h.K2) and the backward products (dK2, dh,
    dK1, dx): 55,488 MAC. fp32 units: softplus and sigmoid once per table
    entry (8 ops); per atom pair d2 (8), the gaussian (2), the masks (2) and
    dcoef and its sum (6); per pair the MLP's bias, ReLU and mask forward and
    backward. Bytes: positions, masks, tokens, g (bf16), the table and the
    weights in, the gradients out."""
    pairs, nodes = B * L * L, B * L
    t_tc = 2 * 3 * (a2 * f + f * f) * pairs / PEAK_BF16_TC
    t_fp32 = (8 * n_pair_types * a2 + (18 * a2 + 10 * f) * pairs) / PEAK_FP32
    nbytes = (nodes * (15 * 3 * 4 + 15 * 4 + 4 + 4) + pairs * f * 2
              + 2 * n_pair_types * a2 * 4 + 2 * (a2 * f + f * f) + 4 * (a2 * f + f * f + 2 * f))
    return _bound(max(t_tc, t_fp32), nbytes)


def edge_int8_bound_ms(B: int, L: int, cz=64, hid=192, cb=64, n_ro=24):
    """(ms, bound_by): K6, the EdgeTransition with readout and the two
    hidden-width products (h1.W2, h2.W3) in int8. Tensor cores, which run
    the int8 and the bf16 products one after another: per pair the int8 MACs
    and the 64-wide bf16 ones (edge.W1e, edge.W3e, readout), per residue the
    node products. fp32 units: K2's elementwise work plus the quantization of
    both hidden rows (row max, scale, round: 4 ops a lane) and their
    dequantization (2 ops a lane). Bytes as K2."""
    pairs, nodes = B * L * L, B * L
    t_int8 = 2 * (hid * hid + hid * cz) * pairs / PEAK_INT8_TC
    t_bf16 = 2 * ((cz * hid + cz * cz + cz * n_ro) * pairs + cb * (2 * hid + 2 * cz) * nodes) \
        / PEAK_BF16_TC
    t_fp32 = (4 * hid + 2 * hid + 3 * cz + 7 * cz + cz + n_ro + 6 * 2 * hid) * pairs / PEAK_FP32
    weights = 2 * (hid * hid * 2 + hid * cz + cz * n_ro) + 4 * (2 * hid + 4 * cz + n_ro)
    nbytes = pairs * (2 * cz + 2 * cz + 2 * n_ro) + nodes * (2 * cb + 4) + weights
    return _bound(max(t_int8 + t_bf16, t_fp32), nbytes)


def _ipa_bytes(B, L, H, C, Pq, Pv, cz4):
    """Bytes in and out of the IPA interior in the bf16 profile: q, kv, the
    local points (the projections' bf16 outputs), the pair bias and the
    down-projected pair bf16; frames, the key mask, the point weights and
    every output fp32."""
    ins = 2 * (B * L * H * C * 3 + B * H * 3 * L * (2 * Pq + Pv) + B * H * L * L
               + B * L * L * cz4)
    ins += 4 * (B * L * 12 + B * L + H)
    outs = 4 * B * L * H * (C + 4 * Pv + cz4)
    return ins, outs


def ipa2_bound_ms(B: int, L: int, H=8, C=128, Pq=8, Pv=12, cz4=16):
    """(ms, bound_by): K7, the fused IPA interior (forward). Per (batch,
    head, i, j): the scalar logit and the scalar aggregation (2C MACs) on the
    bf16 tensor cores; the point term (3Pq), the point and pair aggregations
    (3Pv + cz4) and about 10 fp32 ops of bias, mask and softmax on the fp32
    units. Bytes: the interior's inputs and its o_feats outputs."""
    n = B * H * L * L
    t_tc = 2 * 2 * C * n / PEAK_BF16_TC
    t_fp32 = (2 * (3 * Pq + 3 * Pv + cz4) + 10) * n / PEAK_FP32
    ins, outs = _ipa_bytes(B, L, H, C, Pq, Pv, cz4)
    return _bound(max(t_tc, t_fp32), ins + outs)


def ipa2_bwd_bound_ms(B: int, L: int, H=8, C=128, Pq=8, Pv=12, cz4=16):
    """(ms, bound_by): K8, the fused IPA backward. Per (batch, head, i, j):
    the recomputed logit and the products for d_attention, dq, dk and dv
    (5C MACs) on the bf16 tensor cores; the point and pair terms of the
    recompute and of every gradient (3 x 3Pq + 2 x 3Pv + 2 cz4) and about 15
    fp32 ops of softmax backward on the fp32 units. Bytes: the forward's
    inputs and the cotangents of its outputs in, fp32 gradients of every
    input (the pair bias and pair features at (B, H, L, L) and
    (B, L, L, cz4)) out."""
    n = B * H * L * L
    t_tc = 2 * 5 * C * n / PEAK_BF16_TC
    t_fp32 = (2 * (9 * Pq + 6 * Pv + 2 * cz4) + 15) * n / PEAK_FP32
    ins, outs = _ipa_bytes(B, L, H, C, Pq, Pv, cz4)
    grads = 4 * (B * L * H * C * 3 + B * H * L * L + B * L * L * cz4
                 + B * H * 3 * L * (2 * Pq + Pv) + B * L * 12 + B * H)
    return _bound(max(t_tc, t_fp32), ins + outs + grads)


def ipa_v1_bound_ms(B: int, L: int, H=8, C=128, Pq=8, Pv=12, cz4=16, in_bytes=2):
    """(ms, bound_by): K9, the v1 IPA attention core on global-frame points:
    K7's work without the frame transforms and point norms, outputs o, o_pt
    and o_pair per head (fp32). q, k, v, the pair bias and the pair
    features take `in_bytes` an element (2: bf16, 4: fp32); the products of
    q.k and the scalar aggregation count at the bf16 tensor-core rate for
    bf16 inputs and at the fp32 rate for fp32 ones."""
    n = B * H * L * L
    t_tc = 2 * 2 * C * n / PEAK_BF16_TC if in_bytes == 2 else 0.0
    t_fp32 = (2 * (3 * Pq + 3 * Pv + cz4) + 10 + (0 if in_bytes == 2 else 4 * C)) * n / PEAK_FP32
    ins = in_bytes * (B * H * L * C * 3 + B * H * L * L + B * L * L * cz4) \
        + 4 * B * H * L * 3 * (2 * Pq + Pv) + 4 * B * L
    outs = 4 * B * H * L * (C + 3 * Pv + cz4)
    return _bound(max(t_tc, t_fp32), ins + outs)


#: (kernel, what it is, shape it is bounded at, function, arguments)
TABLE = (
    ("K1", "EdgeTransition forward, readout off", "B=32 L=64 (train step)", edge_bound_ms,
     dict(B=32, L=64, n_ro=0)),
    ("K2", "EdgeTransition forward with readout", "B=64 L=64 (sampler)", edge_bound_ms,
     dict(B=64, L=64)),
    ("K3", "distance embedding forward", "B=64 L=64 (sampler)", dist_bound_ms, dict(B=64, L=64)),
    ("K4", "EdgeTransition backward", "B=32 L=64 (train step)", edge_bwd_bound_ms,
     dict(B=32, L=64)),
    ("K5", "distance embedding backward", "B=32 L=64 (train step)", dist_bwd_bound_ms,
     dict(B=32, L=64)),
    ("K6", "int8 EdgeTransition with readout", "B=64 L=64 (sampler)", edge_int8_bound_ms,
     dict(B=64, L=64)),
    ("K6", "int8 EdgeTransition, readout off", "B=64 L=64", edge_int8_bound_ms,
     dict(B=64, L=64, n_ro=0)),
    ("K7", "IPA v2 interior forward", "B=64 L=64 (sampler)", ipa2_bound_ms, dict(B=64, L=64)),
    ("K8", "IPA v2 interior backward", "B=32 L=64 (train step)", ipa2_bwd_bound_ms,
     dict(B=32, L=64)),
    ("K8", "IPA v2 interior backward", "B=32 L=128 (train step, L > 64 path)",
     ipa2_bwd_bound_ms, dict(B=32, L=128)),
    ("K8", "IPA v2 interior backward", "B=32 L=256 (train step, L > 64 path)",
     ipa2_bwd_bound_ms, dict(B=32, L=256)),
    ("K9", "IPA v1 attention core, bf16", "B=64 L=64, model widths (no model path)",
     ipa_v1_bound_ms, dict(B=64, L=64)),
)


def _wide_rows(w: int, B: int):
    """K1-K8 at `w` times the flagship widths (c_z = F = 64 w, hidden 3 c_z,
    readout 8 + c_z/4 lanes; the IPA's C = 128 w, CZ4 = 16 w) at batch B, L =
    64, and K8 also at L = 128 and half the batch."""
    cz, shape = 64 * w, f"B={B} L=64 ({w}x, width sweep)"
    edge = dict(B=B, L=64, cz=cz, hid=3 * cz, cb=cz)
    ipa = dict(C=128 * w, cz4=16 * w)
    return (("K1", "EdgeTransition forward, readout off", shape, edge_bound_ms, {**edge, "n_ro": 0}),
            ("K2", "EdgeTransition forward with readout", shape, edge_bound_ms,
             {**edge, "n_ro": 8 + cz // 4}),
            ("K3", "distance embedding forward", shape, dist_bound_ms, dict(B=B, L=64, f=cz)),
            ("K4", "EdgeTransition backward", shape, edge_bwd_bound_ms, edge),
            ("K5", "distance embedding backward", shape, dist_bwd_bound_ms, dict(B=B, L=64, f=cz)),
            ("K6", "int8 EdgeTransition with readout", shape, edge_int8_bound_ms,
             {**edge, "n_ro": 8 + cz // 4}),
            ("K7", "IPA v2 interior forward", shape, ipa2_bound_ms, dict(B=B, L=64, **ipa)),
            ("K8", "IPA v2 interior backward", shape, ipa2_bwd_bound_ms, dict(B=B, L=64, **ipa)),
            ("K8", "IPA v2 interior backward", f"B={B // 2} L=128 ({w}x, L > 64)",
             ipa2_bwd_bound_ms, dict(B=B // 2, L=128, **ipa)))


#: K1-K8 at the JAX package's 2x, 4x and 8x widths, at the width sweep's
#: batches (tools/width_sweep.py: 64, 32 and 8).
TABLE += sum((_wide_rows(w, B) for w, B in ((2, 64), (4, 32), (8, 8))), ())


def main() -> None:
    print("kernel | what | shape | bound us (by); computed from the shapes for one H100 SXM "
          "at its published peaks (700 W), not measured")
    for name, what, shape, fn, kw in TABLE:
        ms, by = fn(**kw)
        print(f"{name} | {what} | {shape} | {1e3 * ms:.1f} ({by})")


if __name__ == "__main__":
    main()
