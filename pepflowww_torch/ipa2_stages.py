"""Stage times of the fused IPA forward kernel (K7) on one GPU.

    python -m pepflowww_torch.ipa2_stages [--batch 64] [--length 64]

Builds ``csrc/ipa2.cu`` with ``-DIPA2_STAMPS`` (a diagnostic build, beside
the package's own library), in which each block records the device's global
timer at its stage boundaries, and calls it three times on seeded inputs in
the sampler's layout (bias (B, H, L, L), the pair readout a view of
(B, CZ4, L, L)) at the production widths. It prints, from the last call, the
mean time a block spends in each stage, for the blocks that started with the
launch and for those that started later, and the launch's span. L is at most
64 (one key tile). The stamps cost a global store per stage; the span is not
the kernel's time (``chip_smoke.py`` times it).

Runs on CUDA only: it measures the device.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess

import torch

from pepflowww_torch import native
from pepflowww_torch.models import cuda_ipa

H, C, PQ, PV, CZ4 = 8, 128, 8, 12, 16
N_STAMPS = 11
STAGES = ("point fetches", "Q/K/V/bias copies", "pair copies", "frames stored",
          "points to global", "copies landed", "logits+softmax", "o product", "aggregations",
          "outputs")


def stamped_forward():
    """``ipa2_forward_stamps`` of a fresh diagnostic build of csrc/ipa2.cu."""
    os.makedirs(native.BUILD_DIR, exist_ok=True)
    out = os.path.join(native.BUILD_DIR, "libipa2_stamps.so")
    res = subprocess.run([native._nvcc(), *native.NVCC_FLAGS, "-DIPA2_STAMPS", "-o", out,
                          os.path.join(native.CSRC_DIR, "ipa2.cu")],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for csrc/ipa2.cu -DIPA2_STAMPS:\n{res.stdout}{res.stderr}")
    fn = ctypes.CDLL(out).ipa2_forward_stamps
    fn.argtypes = cuda_ipa._ARGTYPES[:-1] + [ctypes.c_void_p, ctypes.c_void_p]
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--length", type=int, default=64)
    args = ap.parse_args(argv)
    B, L = args.batch, args.length
    if not 1 <= L <= 64:
        ap.error("--length must be 1..64 (one key tile)")
    if not torch.cuda.is_available():
        raise SystemExit("ipa2_stages needs a CUDA device")
    dev = torch.device("cuda")
    fn = stamped_forward()
    _, ins, strides = cuda_ipa._kernel_inputs(*sampler_inputs(B, L, dev))
    outs = [torch.empty(B, L, w, device=dev) for w in (H * C, 3 * H * PV, H * PV, H * CZ4)]
    st = torch.zeros(B * H * ((L + 63) // 64), N_STAMPS, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for _ in range(3):   # the last of three calls
        native.check(fn(*[x.data_ptr() for x in ins + outs], strides, B, L, H, 1e-8,
                        st.data_ptr(), stream), "ipa2 stamps")
    torch.cuda.synchronize()
    s = st.double().cpu()
    s -= s[:, 0].min()
    first = s[:, 0] < 0.5 * float(s[:, 0].max())   # started with the launch, or after a block ended
    for label, sel in (("first wave", first), ("later blocks", ~first)):
        d = (s[sel, 1:] - s[sel, :-1]).mean(0) / 1e3
        print(f"ipa2 B={B} L={L} stages, {label} ({int(sel.sum())} blocks), mean us a block: "
              + ", ".join(f"{n} {float(v):.2f}" for n, v in zip(STAGES, d))
              + f"; block {float((s[sel, 10] - s[sel, 0]).mean()) / 1e3:.2f}")
    print(f"ipa2 B={B} L={L} stamped launch: span {float(s[:, 10].max()) / 1e3:.2f} us")


if __name__ == "__main__":
    main()
