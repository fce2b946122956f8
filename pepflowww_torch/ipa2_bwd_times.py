"""Times of the fused IPA backward (K8) on one GPU, for one checkout or for
several in turns.

    python -m pepflowww_torch.ipa2_bwd_times [--shapes 32x64 32x128 32x256]
    python -m pepflowww_torch.ipa2_bwd_times --trees DIR_A DIR_B [--shapes ...]

At each B x L it calls ``cuda_ipa.ipa2_bwd`` in the training step's layouts
(the pair bias a view of linear_b's (B, L, L, H), the pair readout down_z's
(B, L, L, CZ4)) on seeded inputs and cotangents, and prints the mean device
time of a call (CUDA events over 20 calls after 3 warm-up calls, as
``chip_smoke.cuda_ms``), the kernels it launches a call and the bound of
``bounds.ipa2_bwd_bound_ms``, with the card's name and power limit.

With ``--trees`` each directory (a checkout, or an unpacked ``git archive``,
holding ``pepflowww_torch/``) is timed in a process of its own that imports
the package from there and builds its ``csrc/ipa2_bwd.cu``: the trees in
the order given, then in reverse (A, B, B, A), so that two versions are
compared within one call on one card.

Runs on CUDA only: it measures the device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

H, C, PQ, PV, CZ4 = 8, 128, 8, 12, 16


def train_inputs(B, L, dev, seed):
    """The backward's inputs as the training step passes them (bf16 where
    the model feeds bf16, random rotations, ~15% of the keys masked) and
    the cotangents of the forward's four outputs."""
    import torch

    def r(*s, sc=1.0, k=0):
        return torch.randn(*s, generator=torch.Generator().manual_seed(seed + k)).to(dev) * sc

    bf = torch.bfloat16
    R = torch.linalg.qr(r(B, L, 3, 3, k=1))[0]
    mask = (torch.rand(B, L, generator=torch.Generator().manual_seed(seed)) > 0.15).float().to(dev)
    args = [r(B, L, H * C, k=7).to(bf), r(B, L, 2 * H * C, k=8).to(bf),
            r(B, L, 3, H, PQ, sc=2.0, k=2).to(bf).permute(0, 3, 2, 1, 4),
            r(B, L, 3, H, PQ + PV, sc=2.0, k=3).to(bf).permute(0, 3, 2, 1, 4),
            R.reshape(B, L, 9).contiguous(), r(B, L, 3, sc=5.0, k=9),
            r(B, L, L, H, k=4).to(bf).permute(0, 3, 1, 2), r(B, L, L, CZ4, k=5).to(bf),
            (1e5 * (mask - 1.0))[:, None, :], r(1, H, sc=0.1, k=6).abs() + 0.2]
    cots = [r(B, L, w, k=100 + n) for n, w in enumerate((H * C, 3 * H * PV, H * PV, H * CZ4))]
    return args, cots


def time_shapes(shapes):
    """[(B, L, us a call, launches a call, bound us, bound_by)] for the
    package on sys.path."""
    import torch

    from pepflowww_torch import native
    from pepflowww_torch.bounds import ipa2_bwd_bound_ms
    from pepflowww_torch.models import cuda_ipa

    dev = torch.device("cuda", 0)
    per_call = native.function("ipa2_bwd", "ipa2_bwd_kernels_per_call", [ctypes.c_int])
    rows = []
    for B, L in shapes:
        args, cots = train_inputs(B, L, dev, seed=700 + L)
        call = lambda: cuda_ipa.ipa2_bwd(*args, *cots)
        for _ in range(3):
            call()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(20):
            call()
        end.record()
        torch.cuda.synchronize()
        bound, by = ipa2_bwd_bound_ms(B, L)
        rows.append((B, L, 1e3 * start.elapsed_time(end) / 20, per_call(L), 1e3 * bound, by))
    return rows


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 else "nvidia-smi failed"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", nargs="+", default=["32x64", "32x128", "32x256"],
                    help="B x L pairs, e.g. 32x128")
    ap.add_argument("--trees", nargs="+", help="checkouts to time in turns (A, B, B, A)")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    shapes = [tuple(int(x) for x in s.split("x")) for s in args.shapes]
    if args.child:   # one tree, in this process: one JSON line
        print(json.dumps(time_shapes(shapes)), flush=True)
        return
    import torch

    if not torch.cuda.is_available():
        sys.exit("CUDA is not available: ipa2_bwd_times measures the device")
    print(f"card: {card_line()}", flush=True)
    if not args.trees:
        runs = [(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 time_shapes(shapes))]
    else:
        runs = []
        for tree in args.trees + args.trees[::-1]:
            root = os.path.abspath(tree)
            code = ("import sys; sys.path.insert(0, sys.argv[1]); "
                    "sys.argv = [sys.argv[0]] + sys.argv[2:]; "
                    f"exec(open({os.path.abspath(__file__)!r}).read())")
            res = subprocess.run([sys.executable, "-c", code, root, "--child", "1", "--shapes",
                                  *args.shapes], capture_output=True, text=True, cwd=root)
            if res.returncode != 0:
                sys.exit(f"{tree}: the timing run failed:\n{res.stdout}{res.stderr}")
            runs.append((root, json.loads(res.stdout.strip().splitlines()[-1])))
    for root, rows in runs:
        for B, L, us, n, bound, by in rows:
            print(f"{root}: ipa2_bwd B={B} L={L}: {us:.1f} us a call ({n} launches), bound "
                  f"{bound:.1f} us ({by}), {100 * bound / us:.1f}% of it", flush=True)


if __name__ == "__main__":
    main()
