"""Stage times of the fused IPA kernels (K7 forward, K8 backward) on one GPU.

    python -m pepflowww_torch.ipa2_stages [--batch 64] [--length 64]
    python -m pepflowww_torch.ipa2_stages --backward [--batch 32] [--length 64]

Builds ``csrc/ipa2.cu`` (or, with ``--backward``, ``csrc/ipa2_bwd.cu``) with
``-DIPA2_STAMPS`` (a diagnostic build, beside the package's own library), in
which each block records the device's global timer at its stage boundaries,
and calls it three times on seeded inputs at the production widths: the
forward in the sampler's layout (bias (B, H, L, L), the pair readout a view
of (B, CZ4, L, L)), the backward in the training step's (bias a view of
(B, L, L, H), the pair readout (B, L, L, CZ4)) with seeded cotangents. It
prints, from the last call, the mean time a block spends in each stage, for
the blocks that started with the launch and for those that started later,
and the launch's span (for the backward, of the tile kernel's blocks). L
is at most 64 (one key tile; the backward's tile kernel), but for the
backward above 64, where each block of its query and key kernels sums its
SM clock cycles in each stage over its tiles: the mean per block of each,
in cycles and in us at the card's maximum SM clock. The stamps cost a
global store per stage (and a clock read per stage and tile); the span is
not the kernel's time (``chip_smoke.py`` times it).

Runs on CUDA only: it measures the device.
"""

from __future__ import annotations

import argparse
import ctypes

import torch

from pepflowww_torch import native
from pepflowww_torch.kernel_times import max_sm_mhz
from pepflowww_torch.models import cuda_ipa

H, C, PQ, PV, CZ4 = 8, 128, 8, 12, 16
STAGES = ("point fetches", "Q/K/V/bias copies", "pair copies", "frames stored",
          "points to global", "copies landed", "logits+softmax", "o product", "aggregations",
          "outputs")
BWD_STAGES = ("loads, frames", "logits+softmax", "optg, goptg", "g_a product", "point term",
              "pair term, gs", "gq", "gk, gv, gbias", "point gradients", "frame backwards",
              "gqp, gkvp written")
# L > 64: the query and key kernels' stages (csrc/ipa2_bwd.cu NQ_STAGES, NK_STAGES).
QUERY_STAGES = ("setup", "sweep 1 loads", "sweep 1 logits, p", "sweep 1 g' product, pair term",
                "sweep 1 D sums, p.vg", "goptg, D", "sweep 2 loads", "sweep 2 logits, a",
                "sweep 2 g_a", "sweep 2 gs, gq, gbias, gs.kg", "end")
KEY_STAGES = ("setup", "query tile loads", "logits, a", "g_a product, point term", "pair term",
              "gs, a.goptg", "gk, gv", "gs.qg", "end")


def stamped(source, name, argtypes):
    """`name` of a fresh diagnostic build of csrc/<source>.cu, taking
    `argtypes` and then the stamps and the stream."""
    fn = getattr(ctypes.CDLL(native.build_stamped((source,), "IPA2_STAMPS")[source]), name)
    fn.argtypes = argtypes[:-1] + [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def sampler_inputs(B, L, dev, seed=0):
    """The kernel's inputs as the sampler passes them, bf16 where the model
    feeds bf16; random rotations, ~15% of the keys masked."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, sc=1.0: (torch.randn(*s, generator=g) * sc).to(dev)
    bf = torch.bfloat16
    R = torch.linalg.qr(r(B, L, 3, 3))[0]
    mask = (torch.rand(B, L, generator=g) > 0.15).float().to(dev)
    return [r(B, L, H * C).to(bf), r(B, L, 2 * H * C).to(bf),
            r(B, L, 3, H, PQ, sc=2.0).to(bf).permute(0, 3, 2, 1, 4),
            r(B, L, 3, H, PQ + PV, sc=2.0).to(bf).permute(0, 3, 2, 1, 4),
            R.reshape(B, L, 9).contiguous(), r(B, L, 3, sc=5.0), r(B, H, L, L).to(bf),
            r(B, CZ4, L, L).to(bf).permute(0, 2, 3, 1), (1e5 * (mask - 1.0))[:, None, :],
            r(1, H, sc=0.1).abs() + 0.2]


def train_inputs(B, L, dev, seed=0):
    """The backward's inputs as the training step passes them: the bias a
    view of linear_b's (B, L, L, H), the pair readout down_z's (B, L, L,
    CZ4); otherwise as :func:`sampler_inputs`."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s, sc=1.0: (torch.randn(*s, generator=g) * sc).to(dev)
    bf = torch.bfloat16
    R = torch.linalg.qr(r(B, L, 3, 3))[0]
    mask = (torch.rand(B, L, generator=g) > 0.15).float().to(dev)
    return [r(B, L, H * C).to(bf), r(B, L, 2 * H * C).to(bf),
            r(B, L, 3, H, PQ, sc=2.0).to(bf).permute(0, 3, 2, 1, 4),
            r(B, L, 3, H, PQ + PV, sc=2.0).to(bf).permute(0, 3, 2, 1, 4),
            R.reshape(B, L, 9).contiguous(), r(B, L, 3, sc=5.0),
            r(B, L, L, H).to(bf).permute(0, 3, 1, 2), r(B, L, L, CZ4).to(bf),
            (1e5 * (mask - 1.0))[:, None, :], r(1, H, sc=0.1).abs() + 0.2]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--backward", action="store_true", help="K8 in the training layout")
    ap.add_argument("--batch", type=int, default=None, help="default 64, 32 with --backward")
    ap.add_argument("--length", type=int, default=64)
    args = ap.parse_args(argv)
    B, L = args.batch or (32 if args.backward else 64), args.length
    if L < 1 or (L > 64 and not args.backward):
        ap.error("--length must be 1..64 (one key tile), or above with --backward")
    if not torch.cuda.is_available():
        raise SystemExit("ipa2_stages needs a CUDA device")
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream
    if args.backward:
        name, stages = "ipa2_bwd", BWD_STAGES
        fn = stamped("ipa2_bwd", "ipa2_backward_stamps", cuda_ipa._BWD_ARGTYPES)
        *_, ins, strides = cuda_ipa._kernel_inputs(*train_inputs(B, L, dev), pz_rows=True)
        g = torch.Generator().manual_seed(1)
        ins += [torch.randn(B, L, w, generator=g).to(dev)
                for w in (H * C, 3 * H * PV, H * PV, H * CZ4)]
        outs = [torch.empty(*shape, device=dev) for shape in (
            (B, L, H * C), (B, L, 2 * H * C), (B, H, 3, L, PQ), (B, H, 3, L, PQ + PV), (B, L, 9),
            (B, L, 3), (B, H, L, L), (B, L, L, CZ4), (B, H))]
        n_t = (L + 63) // 64
        scratch = [(B, H, L, 12) if k == 2 else None for k in range(7)] if L <= 64 else \
            [(B, H, L, 4), (B, H, L, 40), (B, H, L, 12), (B, H, L, 12), (B, H, n_t), (B, H, n_t),
             (B, H, n_t * 64, 64)]
        scratch = [None if sh is None else torch.empty(*sh, device=dev) for sh in scratch]
        ptrs = ([x.data_ptr() for x in ins] + [None if x is None else x.data_ptr() for x in scratch]
                + [x.data_ptr() for x in outs])
        if L > 64:
            return long_stages(fn, ptrs, strides, B, L, n_t, stream)
    else:
        name, stages = "ipa2", STAGES
        fn = stamped("ipa2", "ipa2_forward_stamps", cuda_ipa._ARGTYPES)
        *_, ins, strides = cuda_ipa._kernel_inputs(*sampler_inputs(B, L, dev))
        outs = [torch.empty(B, L, w, device=dev) for w in (H * C, 3 * H * PV, H * PV, H * CZ4)]
        ptrs = [x.data_ptr() for x in ins + outs]
    st = torch.zeros(B * H, len(stages) + 1, dtype=torch.int64, device=dev)
    for _ in range(3):   # the last of three calls
        native.check(fn(*ptrs, strides, B, L, H, 1e-8, st.data_ptr(), stream), f"{name} stamps")
    torch.cuda.synchronize()
    s = st.double().cpu()
    s -= s[:, 0].min()
    first = s[:, 0] < 0.5 * float(s[:, 0].max())   # started with the launch, or after a block ended
    for label, sel in (("first wave", first), ("later blocks", ~first)):
        d = (s[sel, 1:] - s[sel, :-1]).mean(0) / 1e3
        print(f"{name} B={B} L={L} stages, {label} ({int(sel.sum())} blocks), mean us a block: "
              + ", ".join(f"{n} {float(v):.2f}" for n, v in zip(stages, d))
              + f"; block {float((s[sel, -1] - s[sel, 0]).mean()) / 1e3:.2f}")
    print(f"{name} B={B} L={L} stamped launch: span {float(s[:, -1].max()) / 1e3:.2f} us")


def long_stages(fn, ptrs, strides, B, L, n_t, stream):
    """The backward's query and key kernels at L > 64: the mean SM clock
    cycles a block spends in each stage, summed over its tiles."""
    nq, nk = len(QUERY_STAGES), len(KEY_STAGES)
    st = torch.zeros(B * H * n_t * (nq + nk), dtype=torch.int64, device="cuda")
    for _ in range(3):   # the last of three calls
        native.check(fn(*ptrs, strides, B, L, H, 1e-8, st.data_ptr(), stream), "ipa2_bwd stamps")
    torch.cuda.synchronize()
    mhz = max_sm_mhz()
    s = st.double().cpu()
    for label, block, names in (("query", s[:B * H * n_t * nq].reshape(-1, nq), QUERY_STAGES),
                                ("key", s[B * H * n_t * nq:].reshape(-1, nk), KEY_STAGES)):
        mean = block.mean(0)
        print(f"ipa2_bwd B={B} L={L} {label} kernel, mean a block ({block.shape[0]} blocks, "
              f"{n_t} tiles each), cycles (us at {mhz:.0f} MHz): "
              + ", ".join(f"{n} {float(v):.0f} ({float(v) / mhz:.2f})" for n, v in zip(names, mean))
              + f"; block {float(mean.sum()):.0f} ({float(mean.sum()) / mhz:.2f})")


if __name__ == "__main__":
    main()
