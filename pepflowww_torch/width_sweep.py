"""Train-MFU / sampler-pps width sweep of the port: the flagship architecture
at 1x, 2x, 4x and 8x channel width in the production profile (bf16, the
hand-written kernels), the counterpart of the JAX package's
``tools/width_sweep.py``.

    python -m pepflowww_torch.width_sweep [--widths 1,2,4,8] [--batch 64,64,32,8]
        [--out PATH] [--device cuda] [--num_blocks 6] [--steps 6]

c_s, c_z and c_hidden scale together with the width, heads and points stay
fixed (:func:`pepflowww_torch.bench.width_config`); the batches are
synthetic complexes of L = 64 (a 48-residue pocket and a 12-residue peptide,
``pepflowww_torch.bench``'s batches) and the weights seeded random ones. Per
width, as the JAX tool measures: one training step (loss, backward, clip,
Adam) to warm up, then ``--steps`` timed ones; the FLOPs of one step's loss
and backward counted on the same model with the kernels' plain versions
(``bench.train_flops``: the counter cannot see the kernels' ctypes calls),
over the step time and the card's dense bf16 peak (``train_mfu``, null where
the peak is unknown, as on the CPU); a 20-step Euler sampler run once to
warm up and once timed, its rate scaled to 100 steps. One JSON row a width
on stdout with the JAX tool's fields, after a line naming the device (and
on the card its name and power limit); with ``--out`` the rows as a JSON
list. A width that fails (out of memory) gets a row with its ``error``.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from pepflowww_torch import bench

LOSS_WEIGHTS = {"trans_loss": 0.5, "rot_loss": 0.5, "bb_atom_loss": 0.25,
                "seqs_loss": 1.0, "angle_loss": 1.0, "torsion_loss": 0.5}
SAMPLER_STEPS = 20


def run_width(width: int, batch: int, dev, num_blocks: int = 6, steps: int = 6,
              model=None) -> dict:
    """One row of the sweep: the training step's ms, samples/s and MFU, and
    the sampler's peptides/s at 100 steps, at `width` and batch `batch`, of
    `model` (by default a new one of the width's configuration with seeded
    weights; its parameters are trained by the timed steps)."""
    from pepflowww_torch.profile_sampler import production_model
    from pepflowww_torch.sampling import euler_sample
    from pepflowww_torch.training.optim import Optimizer
    from pepflowww_torch.training.train_step import train_step

    cfg = bench.width_config(width, num_blocks)
    model = (model if model is not None else production_model(dev, cfg)).train()
    n_params = sum(p.numel() for p in model.parameters())
    b = bench._batch(dev, batch, bench.PEP_LEN, bench.REC_LEN, bench.PAD_TO)

    opt = Optimizer(model.parameters(), {"type": "adam", "lr": 5e-4}, 100.0)
    gen = torch.Generator(device=dev).manual_seed(0)
    float(train_step(model, opt, b, LOSS_WEIGHTS, gen)["loss"])   # warm-up
    bench._sync(dev)
    t0 = time.perf_counter()
    for _ in range(steps):
        m = train_step(model, opt, b, LOSS_WEIGHTS, gen)
    float(m["loss"])
    bench._sync(dev)
    dt = (time.perf_counter() - t0) / steps

    plain = production_model(dev, cfg, use_kernels=False).train()
    flops = bench.train_flops(plain, b, LOSS_WEIGHTS)
    del plain
    peak = bench.peak_tflops(dev)
    mfu = flops / dt / (peak * 1e12) if peak else None

    model.eval()
    with torch.no_grad():
        euler_sample(model, b, torch.Generator(device=dev).manual_seed(9), num_steps=SAMPLER_STEPS)
        bench._sync(dev)
        t0 = time.perf_counter()
        euler_sample(model, b, torch.Generator(device=dev).manual_seed(10),
                     num_steps=SAMPLER_STEPS)
        bench._sync(dev)
    pps100 = batch / ((time.perf_counter() - t0) * (100 / SAMPLER_STEPS))
    return {"width": width, "batch": batch, "params": n_params,
            "train_step_ms": round(dt * 1e3, 1),
            "train_samples_per_sec": round(batch / dt, 1),
            "train_mfu": round(mfu, 4) if mfu else None,
            "sampler_pps_100step": round(pps100, 2)}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--widths", default="1,2,4,8")
    ap.add_argument("--batch", default="64,64,32,8",
                    help="per-width batch (drops where device memory requires)")
    ap.add_argument("--out", default=None, help="write the rows here as a JSON list")
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--num_blocks", type=int, default=6)
    ap.add_argument("--steps", type=int, default=6, help="timed training steps a width")
    args = ap.parse_args(argv)

    from pepflowww_torch.device import resolve_device

    dev = resolve_device(args.device)
    info = bench.device_info(dev)
    print(f"device: {info['name']}, power limit {info['power_limit']}", flush=True)
    widths = [int(w) for w in args.widths.split(",")]
    batches = [int(b) for b in args.batch.split(",")]
    rows = []
    for w, bsz in zip(widths, batches):
        try:
            row = run_width(w, bsz, dev, args.num_blocks, args.steps)
        except Exception as e:  # out of memory etc.: record and continue
            row = {"width": w, "batch": bsz, "error": repr(e)[:200]}
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
