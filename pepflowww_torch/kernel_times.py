"""Device times of the IPA kernels on one GPU, for one checkout or for
several in turns.

    python -m pepflowww_torch.kernel_times [--kernel ipa2_bwd] [--shapes 32x64 32x128 32x256]
    python -m pepflowww_torch.kernel_times --kernel ipa1 --shapes 64x64 64x128 64x256
    python -m pepflowww_torch.kernel_times --trees DIR_A DIR_B [--kernel ...] [--shapes ...]

``--kernel`` picks the wrapper, called at each B x L on seeded inputs:

* ``ipa2_bwd`` (K8, the default): ``cuda_ipa.ipa2_bwd`` in the training
  step's layouts (the pair bias a view of linear_b's (B, L, L, H), the pair
  readout down_z's (B, L, L, CZ4)), with cotangents of the four outputs;
* ``ipa2`` (K7): ``cuda_ipa.fused_ipa2`` in the sampler's layouts (the
  pair bias (B, H, L, L), the pair readout a view of (B, CZ4, L, L));
* ``ipa1`` (K9): ``cuda_ipa1.fused_ipa_attention``, bf16 at the model's
  widths (H 8, C 128, Pq 8, Pv 12, CZ4 16), head-major.

Each line gives the mean device time of a call (:func:`device_ms`: CUDA
events around 20 calls queued behind a sleep kernel, after 3 warm-up
calls, so that the host's per-call overhead does not pace the device), the
kernels it launches a call and the bound of ``pepflowww_torch.bounds``,
with the card's name and power limit.

``--widths 2,4,8`` times instead K1-K5 (the EdgeTransition forward
without and with the readout, the distance block forward, both backwards)
at those multiples of the flagship widths (c_z = F = 64 w, hidden 3 c_z,
readout 8 + c_z/4 lanes), each at the width sweep's batch (B = 64, 32, 8 at
w = 2, 4, 8; L = 64; :data:`WIDTH_BATCHES`), with the same lines.

With ``--trees`` each directory (a checkout, or an unpacked ``git archive``,
holding ``pepflowww_torch/``) is timed in a process of its own that imports
the package from there and builds its kernels: the trees in the order
given, then in reverse (A, B, B, A), so that two versions are compared
within one call on one card.

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
KERNELS = ("ipa2_bwd", "ipa2", "ipa1")
#: The width sweep's batch at each width (tools/width_sweep.py's), at L = 64.
WIDTH_BATCHES = {1: 64, 2: 64, 4: 32, 8: 8}
WIDE_KERNELS = ("K1", "K2", "K3", "K4", "K5")


def _randn(*shape, seed, scale=1.0):
    import torch

    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed)) * scale


def train_inputs(B, L, dev, seed):
    """The backward's inputs as the training step passes them (bf16 where
    the model feeds bf16, random rotations, ~15% of the keys masked) and
    the cotangents of the forward's four outputs."""
    import torch

    r = lambda *s, sc=1.0, k=0: _randn(*s, seed=seed + k, scale=sc).to(dev)
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


def sampler_inputs(B, L, dev, seed):
    """K7's inputs in the sampler's layouts: the pair bias (B, H, L, L), the
    pair readout a view of the EdgeTransition epilogue's (B, CZ4, L, L)."""
    args, _ = train_inputs(B, L, dev, seed)
    r = lambda *s, k: _randn(*s, seed=seed + k).to(dev).bfloat16()
    args[6], args[7] = r(B, H, L, L, k=4), r(B, CZ4, L, L, k=5).permute(0, 2, 3, 1)
    return args


def v1_inputs(B, L, dev, seed):
    """K9's inputs at the model's widths, head-major: q, k, v, bias and
    pair_z in bf16, global points fp32, ~15% of the keys masked."""
    import torch

    r = lambda *s, k: _randn(*s, seed=seed + k).to(dev)
    bf = torch.bfloat16
    mask = (torch.rand(B, L, generator=torch.Generator().manual_seed(seed)) > 0.15).float().to(dev)
    return [r(B, H, L, C, k=1).to(bf), r(B, H, L, C, k=2).to(bf), r(B, H, L, C, k=3).to(bf),
            r(B, H, L, 3 * PQ, k=4), r(B, H, L, 3 * PQ, k=5), r(B, H, L, 3 * PV, k=6),
            r(B, H, L, L, k=7).to(bf), r(B, L, L, CZ4, k=8).to(bf), mask]


def wide_calls(width: int, B: int, dev, seed: int, L: int = 64) -> dict:
    """K1-K5 at `width` times the flagship widths on seeded inputs: {name:
    (kernel call, plain call, (bound ms, bound_by), device launches a call,
    the registry's name)}. The EdgeTransition's edge, node bias and
    cotangent bf16 with ~10% of the residues masked, weights N(0, 1/fan_in),
    the readout the next block's 8 heads and c_z/4 channels; the distance
    block on the main path's synthetic complexes (a 48-residue pocket and a
    12-residue peptide) with a N(0, 1) table."""
    import numpy as np
    import torch

    from pepflowww_torch import bounds, native
    from pepflowww_torch.data.collate import device_batch
    from pepflowww_torch.data.synthetic import make_batch
    from pepflowww_torch.models import cuda_dist, cuda_edge

    cz, bf = 64 * width, torch.bfloat16
    hid, n_ro = 3 * cz, 8 + cz // 4
    r = lambda *s, sc=1.0, k=0: _randn(*s, seed=seed + k, scale=sc).to(dev)
    p = {"k1": r(hid, hid, sc=hid ** -0.5, k=1), "b1": r(hid, sc=0.1, k=2),
         "k2": r(hid, hid, sc=hid ** -0.5, k=3), "b2": r(hid, sc=0.1, k=4),
         "k3": r(hid, cz, sc=hid ** -0.5, k=5), "b3": r(cz, sc=0.1, k=6),
         "ln_scale": 1 + r(cz, sc=0.1, k=7), "ln_bias": r(cz, sc=0.1, k=8)}
    ro = (r(cz, 8, sc=cz ** -0.5, k=9), r(8, sc=0.1, k=10), r(cz, cz // 4, sc=cz ** -0.5, k=11),
          r(cz // 4, sc=0.1, k=12))
    edge, nb, g = r(B, L, L, cz, k=13).to(bf), r(B, L, cz, k=14).to(bf), r(B, L, L, cz, k=15).to(bf)
    mask = (torch.rand(B, L, generator=torch.Generator().manual_seed(seed)) > 0.1).float().to(dev)
    ops, ops_ro = cuda_edge.kernel_operands(p), cuda_edge.kernel_operands(p, ro)
    b = device_batch(make_batch(np.random.default_rng(seed), batch_size=B, pep_len=12,
                                rec_len=48, pad_to=L), dev)
    smask = b["mask_heavyatom"][:, :, 1].float() * (~b["generate_mask"]).float()
    dargs = (b["pos_heavyatom"] * 0.1, b["mask_heavyatom"].float(), b["aa"], smask)
    pd = {"table": r(484, 225, k=16), "k1": r(225, cz, sc=0.07, k=17), "b1": r(cz, sc=0.1, k=18),
          "k2": r(cz, cz, sc=cz ** -0.5, k=19), "b2": r(cz, sc=0.1, k=20)}
    dops, gd = cuda_dist.kernel_operands(pd), r(B, L, L, cz, k=21).to(bf)
    per_call = lambda lib, fn, *a: native.function(lib, fn, [ctypes.c_int] * len(a))(*a)
    return {
        "K1": (lambda: cuda_edge.fused_edge_transition(edge, nb, mask, p, ops=ops),
               lambda: cuda_edge.edge_transition_plain(edge, nb, mask, p, bf),
               bounds.edge_bound_ms(B, L, cz, hid, cz, n_ro=0),
               per_call("edge_transition", "edge_transition_wide_kernels_per_call", 0),
               "edge_transition"),
        "K2": (lambda: cuda_edge.fused_edge_transition(edge, nb, mask, p, readout=ro, ops=ops_ro),
               lambda: cuda_edge.edge_transition_plain(edge, nb, mask, p, bf, ro),
               bounds.edge_bound_ms(B, L, cz, hid, cz, n_ro=n_ro),
               per_call("edge_transition", "edge_transition_wide_kernels_per_call", 1),
               "edge_transition"),
        "K3": (lambda: cuda_dist.fused_distance_embed(*dargs, pd, ops=dops),
               lambda: cuda_dist.distance_embed_plain(*dargs, pd, bf),
               bounds.dist_bound_ms(B, L, f=cz),
               per_call("distance_embed", "distance_embed_wide_kernels_per_call"),
               "distance_embed"),
        "K4": (lambda: cuda_edge.edge_transition_bwd(edge, nb, mask, p, g, ops=ops,
                                                     d_edge_dtype=bf),
               lambda: cuda_edge.edge_transition_bwd_plain(edge, nb, mask, p, g, bf),
               bounds.edge_bwd_bound_ms(B, L, cz, hid, cz),
               per_call("edge_transition_bwd", "edge_transition_wide_bwd_kernels_per_call"),
               "edge_transition_bwd"),
        "K5": (lambda: cuda_dist.distance_embed_bwd(*dargs, pd, gd, ops=dops),
               lambda: cuda_dist.distance_embed_bwd_plain(*dargs, pd, gd, bf),
               bounds.dist_bwd_bound_ms(B, L, f=cz),
               per_call("distance_embed_bwd", "distance_embed_wide_bwd_kernels_per_call"),
               "distance_embed_bwd")}


def time_widths(widths):
    """[(width, B, kernel, us a call, launches a call, bound us, bound_by)]
    of K1-K5 at each of `widths`, at the sweep's batch."""
    import torch

    dev = torch.device("cuda", 0)
    rows = []
    for w in widths:
        B = WIDTH_BATCHES[w]
        for name, (call, _, (bound, by), per_call, _) in wide_calls(w, B, dev, 40 + w).items():
            with torch.no_grad():
                ms = device_ms(call)
            rows.append((w, B, name, 1e3 * ms, per_call, 1e3 * bound, by))
        torch.cuda.empty_cache()
    return rows


def device_ms(call, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of `call` in ms: CUDA events around `reps` calls that
    are queued behind a sleep kernel, so that the device runs them back to
    back however slow the host is to issue them. The sleep doubles until the
    start event is still pending when the last call has been issued."""
    import torch

    for _ in range(warmup):
        call()
    cycles = 20_000_000
    while True:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            call()
        end.record()
        queued = not start.query()
        torch.cuda.synchronize()
        if queued:
            return start.elapsed_time(end) / reps
        cycles *= 2


def time_shapes(shapes, kernel="ipa2_bwd"):
    """[(B, L, us a call, launches a call, bound us, bound_by)] for the
    package on sys.path."""
    import torch

    from pepflowww_torch import bounds, native
    from pepflowww_torch.models import cuda_ipa, cuda_ipa1

    dev = torch.device("cuda", 0)
    rows = []
    for B, L in shapes:
        if kernel == "ipa2_bwd":
            args, cots = train_inputs(B, L, dev, seed=700 + L)
            call = lambda: cuda_ipa.ipa2_bwd(*args, *cots)
            per_call = native.function("ipa2_bwd", "ipa2_bwd_kernels_per_call", [ctypes.c_int])(L)
            bound, by = bounds.ipa2_bwd_bound_ms(B, L)
        elif kernel == "ipa2":
            args = sampler_inputs(B, L, dev, seed=500 + L)
            call, per_call = lambda: cuda_ipa.fused_ipa2(*args), 1
            bound, by = bounds.ipa2_bound_ms(B, L)
        else:
            args = v1_inputs(B, L, dev, seed=1000 + L)
            call, per_call = lambda: cuda_ipa1.fused_ipa_attention(*args), 1
            bound, by = bounds.ipa_v1_bound_ms(B, L)
        with torch.no_grad():
            ms = device_ms(call)
        rows.append((B, L, 1e3 * ms, per_call, 1e3 * bound, by))
    return rows


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 else "nvidia-smi failed"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=KERNELS, default="ipa2_bwd",
                    help="K8 (ipa2_bwd), K7 (ipa2) or K9 (ipa1)")
    ap.add_argument("--shapes", nargs="+", default=["32x64", "32x128", "32x256"],
                    help="B x L pairs, e.g. 32x128")
    ap.add_argument("--widths", help="time K1-K5 at these multiples of the flagship widths "
                                     "instead, e.g. 2,4,8 (batches 64, 32, 8)")
    ap.add_argument("--trees", nargs="+", help="checkouts to time in turns (A, B, B, A)")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    shapes = [tuple(int(x) for x in s.split("x")) for s in args.shapes]
    if args.child:   # one tree, in this process: one JSON line
        print(json.dumps(time_shapes(shapes, args.kernel)), flush=True)
        return
    import torch

    if not torch.cuda.is_available():
        sys.exit("CUDA is not available: kernel_times measures the device")
    print(f"card: {card_line()}", flush=True)
    if args.widths:
        for w, B, name, us, n, bound, by in time_widths([int(x) for x in args.widths.split(",")]):
            print(f"w={w} B={B} L=64 {name}: {us:.1f} us a call ({n} launches), bound "
                  f"{bound:.1f} us ({by}), {100 * bound / us:.1f}% of it", flush=True)
        return
    if not args.trees:
        runs = [(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 time_shapes(shapes, args.kernel))]
    else:
        runs = []
        for tree in args.trees + args.trees[::-1]:
            root = os.path.abspath(tree)
            code = ("import sys; sys.path.insert(0, sys.argv[1]); "
                    "sys.argv = [sys.argv[0]] + sys.argv[2:]; "
                    f"exec(open({os.path.abspath(__file__)!r}).read())")
            res = subprocess.run([sys.executable, "-c", code, root, "--child", "--kernel",
                                  args.kernel, "--shapes", *args.shapes],
                                 capture_output=True, text=True, cwd=root)
            if res.returncode != 0:
                sys.exit(f"{tree}: the timing run failed:\n{res.stdout}{res.stderr}")
            runs.append((root, json.loads(res.stdout.strip().splitlines()[-1])))
    for root, rows in runs:
        for B, L, us, n, bound, by in rows:
            print(f"{root}: {args.kernel} B={B} L={L}: {us:.1f} us a call ({n} launches), bound "
                  f"{bound:.1f} us ({by}), {100 * bound / us:.1f}% of it", flush=True)


if __name__ == "__main__":
    main()
