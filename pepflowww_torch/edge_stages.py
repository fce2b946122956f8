"""Stage times of the wide EdgeTransition kernels at the JAX package's 2x,
4x and 8x widths on one GPU: the forwards' tile kernel (K1/K2 and K6,
csrc/edge_wide.cuh) and the backward's chain kernel (K4,
csrc/edge_transition_bwd.cu).

    python -m pepflowww_torch.edge_stages [--widths 2,4,8]

Builds ``csrc/edge_transition.cu`` and ``csrc/edge_transition_int8.cu``
with ``-DEDGE_WIDE_STAMPS`` and ``csrc/edge_transition_bwd.cu`` with
``-DEDGE_BWD_STAMPS`` (diagnostic builds, beside the package's own
libraries), in which consumer thread 0 of each block of the tile (chain)
kernel sums the SM clock cycles of each stage of its tiles and the cycles it
waited for the weight ring's slots to fill, and calls K2 (readout on), K1,
K6 (readout on) and K4 three times each on kernel_times' seeded inputs at
the width sweep's batch (B = 64, 32, 8 at L = 64). It prints, from the last
call, each stage's mean cycles a block, its share of the block's cycles and
its time a tile at the card's maximum SM clock, the cycles waited for the
ring (inside the stages' products), the tiles a block, and the stamped
call's device time; for K4 also each of its four device kernels' time
(CUDA events around them in the diagnostic build). The stamps cost a clock
read a stage; the device time here is not the kernel's (kernel_times and
``chip_smoke.py`` time that).

Runs on CUDA only: it measures the device.
"""

from __future__ import annotations

import argparse
import ctypes

import torch

from pepflowww_torch import native
from pepflowww_torch.kernel_times import (WIDTH_BATCHES, card_line, device_ms, edge_inputs,
                                          max_sm_mhz)
from pepflowww_torch.models import cuda_edge

STAGES = ("e gather", "layer 1", "o = e.W3e", "hidden layers", "q2, q2.W3q", "LayerNorm, out",
          "readout")
K4_STAGES = ("e gather", "h1", "a2, r, o", "LayerNorm backward", "dr, da2", "d_edge init",
             "dh1, da1, d_edge", "d_edge out")
K4_KERNELS = ("node pre-pass", "chain", "weight gradients", "reduction")
N_STAMPS = 10   # both kernels: their stages, then the ring waits and the tiles (and a spare)
# library -> (its diagnostic build's macro, the wide entry point, its argument types)
LIBS = {"edge_transition": ("EDGE_WIDE_STAMPS", "edge_transition_wide_forward",
                            cuda_edge._WIDE_ARGTYPES),
        "edge_transition_int8": ("EDGE_WIDE_STAMPS", "edge_transition_int8_wide_forward",
                                 cuda_edge._INT8_WIDE_ARGTYPES),
        "edge_transition_bwd": ("EDGE_BWD_STAMPS", "edge_transition_wide_backward",
                                cuda_edge._WIDE_BWD_ARGTYPES)}


def use(paths: dict) -> dict:
    """Points the wrappers' wide entry points at the diagnostic builds
    (native's table of loaded functions); returns each library's stamp
    reader and, for the backward, its reader of the four kernels' times."""
    readers = {}
    for lib, path in paths.items():
        cdll = ctypes.CDLL(path)
        _, entry, argtypes = LIBS[lib]
        entries = [(entry, argtypes)]
        if lib != "edge_transition_bwd":
            entries.append((f"{lib}_wide_scratch_bytes", [ctypes.c_int] * 3))
        for name, types in entries:
            fn = getattr(cdll, name)
            fn.argtypes, fn.restype = types, ctypes.c_int
            native._FUNCS[(lib, name)] = fn
        reader = cdll.edge_bwd_read_stamps if lib == "edge_transition_bwd" else \
            cdll.edge_wide_read_stamps
        reader.argtypes, reader.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int
        readers[lib] = reader
        if lib == "edge_transition_bwd":
            ev = cdll.edge_bwd_read_event_ms
            ev.argtypes, ev.restype = [ctypes.c_void_p], ctypes.c_int
            readers["events"] = ev
    return readers


def _per_stage(reader, lib, blocks, names, mhz):
    """({stage: (cycles a block, share, us a tile)}, waits, tiles a block)
    from the last call's stamps."""
    buf = (ctypes.c_longlong * (N_STAMPS * blocks))()
    native.check(reader(ctypes.addressof(buf), blocks), f"{lib} stamps")
    sums = [[buf[b * N_STAMPS + k] for k in range(N_STAMPS)] for b in range(blocks)]
    mean = [sum(s[k] for s in sums) / blocks for k in range(N_STAMPS)]
    total = sum(mean[:len(names)])
    waits, tiles = mean[len(names)], mean[len(names) + 1]
    per = {st: (mean[k], mean[k] / total, mean[k] / tiles / mhz) for k, st in enumerate(names)}
    return per, waits, tiles


def stages(width: int, readers: dict, mhz: float) -> list:
    """[(kernel, {stage: (cycles a block, share, us a tile)}, waits, tiles a
    block, device ms, K4's four kernels' ms or None)] for K2, K1, K6 and K4
    at `width`."""
    dev = torch.device("cuda", 0)
    B, L = WIDTH_BATCHES[width], 64
    p, ro, edge, nb, g, mask = edge_inputs(width, B, dev, 40 + width, L)
    sms = native.sm_count(dev)
    blocks = min(sms, -(-B * L * L // 64))
    rows = []
    for name, lib, int8, readout in (("K2", "edge_transition", False, ro),
                                     ("K1", "edge_transition", False, None),
                                     ("K6", "edge_transition_int8", True, ro)):
        ops = cuda_edge.kernel_operands(p, readout, quant_int8=int8)
        fn = cuda_edge.fused_edge_transition_int8 if int8 else cuda_edge.fused_edge_transition
        call = lambda: fn(edge, nb, mask, p, readout=readout, ops=ops)
        with torch.no_grad():
            ms = device_ms(call, reps=3, warmup=2)
        rows.append((name, *_per_stage(readers[lib], lib, blocks, STAGES, mhz), ms, None))
    ops = cuda_edge.kernel_operands(p)
    call = lambda: cuda_edge.edge_transition_bwd(edge, nb, mask, p, g, ops=ops,
                                                 d_edge_dtype=torch.bfloat16)
    ms = device_ms(call, reps=3, warmup=2)
    kernels = (ctypes.c_float * 4)()
    native.check(readers["events"](ctypes.addressof(kernels)), "edge_transition_bwd events")
    grid, _ = cuda_edge.wide_bwd_schedule(B, L, 64 * width, sms)
    rows.append(("K4", *_per_stage(readers["edge_transition_bwd"], "edge_transition_bwd", grid,
                                   K4_STAGES, mhz), ms, list(kernels)))
    return rows


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--widths", default="2,4,8", help="multiples of the flagship widths")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: edge_stages measures the device")
    print(f"card: {card_line()}", flush=True)
    readers = use(native.build_stamped(LIBS, {lib: d for lib, (d, _, _) in LIBS.items()}))
    mhz = max_sm_mhz()
    for w in (int(x) for x in args.widths.split(",")):
        for name, per, waits, tiles, ms, kernels in stages(w, readers, mhz):
            parts = ", ".join(f"{st} {100 * sh:.1f}% ({us:.2f} us)" for st, (_, sh, us)
                              in per.items() if sh > 0)
            total = sum(c for c, _, _ in per.values())
            split = "" if kernels is None else "; device kernels " + ", ".join(
                f"{k} {1e3 * t:.1f} us" for k, t in zip(K4_KERNELS, kernels))
            print(f"w={w} {name}: {tiles:.1f} tiles a block, {total / tiles / mhz:.2f} us a tile "
                  f"at {mhz:.0f} MHz: {parts}; waiting for the ring {100 * waits / total:.1f}%; "
                  f"stamped call {1e3 * ms:.1f} us{split}", flush=True)


if __name__ == "__main__":
    main()
