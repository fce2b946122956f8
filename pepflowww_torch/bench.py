"""Benchmark entry point of the port: sampling and training throughput of
the production profile on one GPU, as one JSON line.

    python -m pepflowww_torch.bench [--device cuda]

The workload is the JAX package's ``bench.py``'s: full codesign (backbone,
torsions and sequence), B=64 complexes of L=64 (a 48-residue pocket and a
12-residue peptide), 100 Euler steps; also at the L=96 and L=128 buckets,
and the training step (loss, backward, clip, Adam) at B=32, L=64. The model
and the training settings are the production profile's,
configs/learn_angle_tpu.yaml (6 blocks, c_s 128, c_z 64, bf16, the
hand-written kernels), with seeded random weights.

Keys of the line:

* ``value``: peptides/s at L64_B64 (``sampling_pps`` gives each bucket);
* ``sampling_pps_plain``: the same profile with the kernels' plain PyTorch
  versions at L64_B64, timed in turns with the kernels' runs (kernels,
  plain, plain, kernels, ...; the medians of each);
* ``vs_baseline``: kernels over plain, both from this call. The JAX
  package's denominator, the reference PepFlow in torch on the host CPU,
  needs the reference tree, which the GPU machine does not hold, and its
  A100 figure was an estimate from TPU-side counts: neither is a
  measurement of this card, so neither is reported;
* ``train_samples_per_sec``, ``train_step_ms``;
* ``sampler_flops_per_batch``: one encode and ``NUM_STEPS`` denoise passes
  of the plain model, counted by ``torch.utils.flop_counter.FlopCounterMode``
  (the kernels are ctypes calls the counter cannot see, and their plain
  versions compute the same function); the sampler's per-step host
  arithmetic is not counted;
* ``mfu``: {train, sample, peak_tflops_assumed}, the counted FLOPs per
  second over the card's dense bf16 peak, looked up by device name (null
  for a card not in :data:`PEAK_TFLOPS_BY_NAME`);
* ``device``: {name, power_limit} as ``nvidia-smi`` reads them (a card may
  be set below its maximum power and then runs slower: compare numbers
  only within one call).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

BATCH = 64
REC_LEN = 48
PEP_LEN = 12
PAD_TO = 64
NUM_STEPS = 100
TRAIN_BATCH = 32
#: Sampling buckets: name -> (peptide, pocket, padded length), as in the JAX bench.
BUCKETS = {"L64_B64": (PEP_LEN, REC_LEN, PAD_TO), "L96_B64": (16, 80, 96),
           "L128_B64": (20, 108, 128)}
#: Dense bf16 tensor-core peak (TFLOP/s) by the name CUDA reports.
PEAK_TFLOPS_BY_NAME = {"NVIDIA H100 80GB HBM3": 989.0}   # H100 SXM5
CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs",
                      "learn_angle_tpu.yaml")


def _batch(dev, batch: int, pep_len: int, rec_len: int, pad_to: int):
    from pepflowww_torch.data.collate import device_batch
    from pepflowww_torch.data.synthetic import make_batch

    return device_batch(make_batch(np.random.default_rng(0), batch_size=batch, pep_len=pep_len,
                                   rec_len=rec_len, pad_to=pad_to), dev)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _sample_pps(model, b: dict, seed: int, steps: int = NUM_STEPS) -> float:
    """Peptides/s of one run of `steps` steps on batch `b`."""
    from pepflowww_torch.sampling import euler_sample

    dev = b["aa"].device
    _sync(dev)
    t0 = time.perf_counter()
    euler_sample(model, b, torch.Generator(device=dev).manual_seed(seed), num_steps=steps)
    _sync(dev)
    return b["aa"].shape[0] / (time.perf_counter() - t0)


def bench_sampling(models: dict, b: dict, reps: int = 3) -> dict:
    """{name: peptides/s} of 100-step runs on batch `b`, each model of
    `models` run `reps` times after a 2-step warm-up, in turns (a, b, b, a,
    ...); the median of each model's runs."""
    names = list(models)
    for name in names:
        _sample_pps(models[name], b, 1, steps=2)
    runs = {name: [] for name in names}
    for i in range(reps * len(names)):
        turn = i % (2 * len(names))
        name = names[turn if turn < len(names) else 2 * len(names) - 1 - turn]
        runs[name].append(_sample_pps(models[name], b, 2 + i))
    return {name: float(np.median(v)) for name, v in runs.items()}


def bench_training(model, b: dict, tc: dict, reps: int = 10):
    """(samples/s, ms/step) of the training step with the settings `tc` (a
    config's ``train`` section) on batch `b`, after 3 warm-up steps."""
    from pepflowww_torch.training.optim import Optimizer
    from pepflowww_torch.training.train_step import train_step

    dev = b["aa"].device
    opt = Optimizer(model.parameters(), tc["optimizer"], tc["max_grad_norm"])
    gen = torch.Generator(device=dev).manual_seed(0)
    for _ in range(3):
        train_step(model, opt, b, tc["loss_weights"], gen)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        m = train_step(model, opt, b, tc["loss_weights"], gen)
    float(m["loss"])
    _sync(dev)
    dt = (time.perf_counter() - t0) / reps
    return b["aa"].shape[0] / dt, 1e3 * dt


def sampler_flops(model, b: dict) -> float:
    """FLOPs of one sampler run: one encode and NUM_STEPS denoise passes
    (``NUM_STEPS - 1`` Euler steps and the final prediction) of `model`."""
    from torch.utils.flop_counter import FlopCounterMode

    B = b["aa"].shape[0]
    with torch.no_grad():
        with FlopCounterMode(display=False) as enc:
            rot, tr, ang, seq, node, edge = model.encode(b)
        t = torch.full((B, 1), 0.5, device=b["aa"].device)
        with FlopCounterMode(display=False) as den:
            model.denoise(t, rot, tr, ang, seq, node, edge, b["generate_mask"], b["res_mask"])
    return float(enc.get_total_flops() + NUM_STEPS * den.get_total_flops())


def train_flops(model, b: dict, loss_weights: dict) -> float:
    """FLOPs of one training step's loss and backward of `model` (the
    optimizer's elementwise update is not counted)."""
    from torch.utils.flop_counter import FlopCounterMode

    from pepflowww_torch.training.train_step import loss_and_total

    gen = torch.Generator(device=b["aa"].device).manual_seed(0)
    with FlopCounterMode(display=False) as fc:
        total, _ = loss_and_total(model, b, dict(loss_weights), gen)
        total.backward()
    model.zero_grad(set_to_none=True)
    return float(fc.get_total_flops())


def width_config(width: int, num_blocks: int = 6, use_kernels: bool = True,
                 use_pallas_ipa: bool = False, quant_int8: bool = False):
    """The flagship architecture at `width` times its channel widths, the
    JAX package's ``tools/width_sweep.py`` configuration in the port's
    types: c_s, c_hidden and the node embedding 128 w, c_z and the edge
    embedding 64 w; 8 heads, 8 query and 12 value points at every width, 8
    sequence-transformer heads above 1x (4 at 1x); bf16 and, with
    `use_kernels`, the hand-written kernels (the production profile), with
    `use_pallas_ipa` also the fused IPA interior (the fused-IPA profile),
    with `quant_int8` the int8 EdgeTransition (the int8 serving profile)."""
    from pepflowww_torch.models.flow import FlowModelConfig
    from pepflowww_torch.models.trunk import IPAConfig

    return FlowModelConfig(
        node_embed_size=128 * width, edge_embed_size=64 * width,
        ipa=IPAConfig(c_s=128 * width, c_z=64 * width, c_hidden=128 * width, no_heads=8,
                      no_qk_points=8, no_v_points=12,
                      seq_tfmr_num_heads=8 if width > 1 else 4, seq_tfmr_num_layers=2,
                      num_blocks=num_blocks, dtype="bfloat16", use_pallas=use_kernels,
                      use_pallas_ipa=use_pallas_ipa, quant_int8=quant_int8))


def device_info(dev) -> dict:
    """{name, power_limit} from nvidia-smi for a CUDA device; the device
    type and no limit otherwise."""
    if dev.type != "cuda":
        return {"name": str(dev), "power_limit": None}
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    name, limit = (s.strip() for s in res.stdout.strip().splitlines()[0].split(",", 1))
    return {"name": name, "power_limit": limit}


def peak_tflops(dev):
    if dev.type != "cuda":
        return None
    return PEAK_TFLOPS_BY_NAME.get(torch.cuda.get_device_name(dev))


def bench_ours(dev=None, reps: int = 3, buckets=tuple(BUCKETS)) -> dict:
    """The measurements behind the line; `reps` sets the timed runs: `reps`
    each of the kernels and the plain versions at L64_B64, in turns;
    max(1, reps - 1) at L96 and L128; 10 x reps training steps. Buckets
    left out of `buckets` report null."""
    from pepflowww_torch.config import load_train_config
    from pepflowww_torch.device import resolve_device
    from pepflowww_torch.profile_sampler import production_model

    dev = resolve_device(dev)
    cfg, raw, _ = load_train_config(CONFIG)
    kernels, plain = production_model(dev, cfg, True), production_model(dev, cfg, False)
    b64 = _batch(dev, BATCH, *BUCKETS["L64_B64"])
    pair = bench_sampling({"kernels": kernels, "plain": plain}, b64, reps)
    pps = {name: None for name in BUCKETS}
    pps["L64_B64"], pps_plain = pair["kernels"], pair["plain"]
    for name in buckets:
        if name != "L64_B64":
            b = _batch(dev, BATCH, *BUCKETS[name])
            pps[name] = bench_sampling({name: kernels}, b, max(1, reps - 1))[name]
    sflops = sampler_flops(plain, b64)
    bt = _batch(dev, TRAIN_BATCH, PEP_LEN, REC_LEN, PAD_TO)
    tflops = train_flops(plain.train(), bt, raw["train"]["loss_weights"])
    del plain
    train_sps, step_ms = bench_training(kernels.train(), bt, raw["train"], reps=10 * reps)
    peak = peak_tflops(dev)
    mfu = lambda flops_per_s: round(flops_per_s / (peak * 1e12), 4) if peak else None
    return {"pps": pps["L64_B64"], "sampling_pps": pps, "sampling_pps_plain": pps_plain,
            "train_samples_per_sec": train_sps, "train_step_ms": step_ms,
            "sampler_flops_per_batch": sflops, "train_flops_per_step": tflops,
            "mfu": {"train": mfu(tflops / (step_ms / 1e3)),
                    "sample": mfu(sflops * pps["L64_B64"] / BATCH),
                    "peak_tflops_assumed": peak},
            "device": device_info(dev)}


def report(ours: dict) -> dict:
    """The JSON line's object from :func:`bench_ours`'s measurements."""
    r = lambda x, n=3: None if x is None else round(float(x), n)
    return {
        "metric": "sampled peptides/sec on one GPU (100-step ODE, B=64, L=64, full codesign, "
                  "production profile)",
        "value": r(ours["pps"]),
        "unit": "peptides/sec",
        "vs_baseline": r(ours["pps"] / ours["sampling_pps_plain"]),
        "baseline": "the same profile with the kernels' plain PyTorch versions, same call",
        "sampling_pps": {k: r(v, 2) for k, v in ours["sampling_pps"].items()},
        "sampling_pps_plain": r(ours["sampling_pps_plain"], 2),
        "train_samples_per_sec": r(ours["train_samples_per_sec"], 1),
        "train_step_ms": r(ours["train_step_ms"], 2),
        "sampler_flops_per_batch": ours["sampler_flops_per_batch"],
        "mfu": ours["mfu"],
        "device": ours["device"],
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)
    print(json.dumps(report(bench_ours(args.device))))


if __name__ == "__main__":
    main()
