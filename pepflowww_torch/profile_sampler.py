"""Where the time of the sampler, or of its training step, goes on one GPU.

    python -m pepflowww_torch.profile_sampler [--config PATH] [--out chiprun_out/profile] \
        [--batch_size 64] [--complex 12 48 64]
    python -m pepflowww_torch.profile_sampler --train [--config PATH]

The model of ``--config`` (default the production profile,
configs/learn_angle_tpu.yaml: 6 blocks, c_s 128, c_z 64, bf16; a YAML that
adds ``use_pallas_ipa: true`` gives the fused-IPA profile, one that adds
``quant_int8: true`` the int8 serving profile (sampling only)) with seeded
random weights on 64 synthetic complexes of L=64 (48-residue pocket +
12-residue peptide; ``--batch_size`` and ``--complex PEP REC PAD`` set
another sampler workload, e.g. ``--batch_size 32 --complex 20 135 160``,
the largest bucket of the sample CLI's data phase in chip_smoke.py). It
prints, each on its own line:

* the wall time and peptides/s of 100-step runs with the hand-written
  kernels and with the config's kernel flags off (plain PyTorch), in turns
  (kernels, plain, plain, kernels, three times), and the median of each;
* a ``torch.profiler`` window of a 5-step run: device busy and idle share
  of the window, kernels launched per denoise pass, device time and
  launches per pass by category, the top kernels by device time and each
  hand-written kernel category split by kernel name; the trace is written
  to ``--out``.

With ``--train`` it does the same for the training step at B=32, L=64 (the
config's batch size): ms/step over 10-step runs with the kernels and with
their plain versions in turns, and a profiled window of 3 steps.

Runs on CUDA only: it measures the device.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import time

import numpy as np
import torch

from pepflowww_torch.config import load_config
from pepflowww_torch.data.collate import device_batch
from pepflowww_torch.data.synthetic import make_batch
from pepflowww_torch.device import resolve_device
from pepflowww_torch.models.flow import build_model
from pepflowww_torch.sampling import euler_sample

CATEGORIES = (  # (category, substrings of the kernel name), first match wins
    ("edge_transition_int8 (K6)", ("edge_int8_",)),
    ("ipa2_bwd (K8)", ("ipa2_bwd_",)),
    ("ipa2 (K7)", ("ipa2_fwd_",)),
    ("edge_transition_bwd (K4)", ("edge_bwd_",)),
    ("distance_embed_bwd (K5)", ("dist_bwd_",)),
    ("edge_transition (kernel B)", ("edge_transition_kernel",)),
    ("distance_embed (kernel A)", ("distance_embed_kernel",)),
    ("gemm", ("gemm", "xmma", "cutlass", "cublas", "sm90_", "sm80_")),
    ("softmax", ("softmax",)),
    ("layer_norm", ("layer_norm", "LayerNorm")),
    ("reduce", ("reduce",)),
    ("copy/cat/index", ("copy", "Cat", "cat_", "index", "gather", "scatter")),
    ("elementwise", ("elementwise", "Elementwise")),
)


def production_model(dev, cfg, use_kernels: bool = True, seed: int = 0):
    """The model of `cfg` (a FlowModelConfig, e.g. ``load_config`` of
    configs/learn_angle_tpu.yaml) with seeded random weights; without
    `use_kernels`, every kernel flag off (``quant_int8`` too, which needs the
    kernels: the int8 profile's plain run is the bf16 one). Every
    parameter gets seeded noise on top of the reference init, whose zero
    ("final") layers would otherwise make each EdgeTransition output its
    LayerNorm bias."""
    if not use_kernels:
        cfg = dataclasses.replace(cfg, ipa=dataclasses.replace(cfg.ipa, use_pallas=False,
                                                               use_pallas_ipa=False,
                                                               quant_int8=False))
    model = build_model(cfg, dev, seed=seed)
    g = torch.Generator(device="cpu").manual_seed(seed + 1)
    with torch.no_grad():
        for prm in model.parameters():
            prm.add_((torch.randn(prm.shape, generator=g) * 0.02).to(dev))
    return model


def main_path_batch(dev, batch: int = 64, seed: int = 0, complex_=(12, 48, 64)):
    """(device batch, numpy batch): B complexes of a `complex_` = (peptide,
    pocket, padded length), by default a 48-residue pocket and a 12-residue
    peptide padded to L=64."""
    pep, rec, pad = complex_
    bnp = make_batch(np.random.default_rng(seed), batch_size=batch, pep_len=pep, rec_len=rec,
                     pad_to=pad)
    return device_batch(bnp, dev), bnp


def _timed_run(model, batch, steps: int, seed: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    euler_sample(model, batch, torch.Generator(device=batch["aa"].device).manual_seed(seed),
                 num_steps=steps)
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _category(name: str) -> str:
    for cat, keys in CATEGORIES:
        if any(k in name for k in keys):
            return cat
    return "other"


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def profile_window(run, passes: int, out_dir: str, unit: str = "denoise pass",
                   name: str = "sampler") -> dict:
    """Profile one call of `run`, `passes` units of work; writes
    ``<out_dir>/<name>_trace.json`` and returns the summary it prints."""
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("profile_window"):
            run()
            torch.cuda.synchronize()
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, f"{name}_trace.json"))

    events = list(prof.events())
    window = [e for e in events if e.name == "profile_window"]
    # Ranges recorded on the host (the window's own, the optimizer's
    # `Optimizer.step#...`) are mirrored on the device timeline: not kernels.
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [e for e in device if e.name != "profile_window"
               and not getattr(e, "is_user_annotation", False)
               and getattr(e, "activity_type", None) != "gpu_user_annotation"]
    if not window or not kernels:
        raise RuntimeError("the profiler recorded no device kernels")
    w0, w1 = window[0].time_range.start, window[0].time_range.end
    busy = _busy_us((k.time_range.start, k.time_range.end) for k in kernels)
    by_cat, by_name, n_cat = {}, {}, {}
    for k in kernels:
        d = k.time_range.end - k.time_range.start
        cat = _category(k.name)
        by_cat[cat] = by_cat.get(cat, 0.0) + d
        n_cat[cat] = n_cat.get(cat, 0) + 1
        n, t = by_name.get(k.name, (0, 0.0))
        by_name[k.name] = (n + 1, t + d)
    summary = {"window_ms": (w1 - w0) / 1e3, "busy_ms": busy / 1e3,
               "idle_share": 1.0 - busy / (w1 - w0), "kernels": len(kernels),
               "kernels_per_pass": len(kernels) / passes,
               "by_category_ms_per_pass": {c: t / 1e3 / passes for c, t in
                                           sorted(by_cat.items(), key=lambda x: -x[1])},
               "launches_per_pass": {c: n / passes for c, n in n_cat.items()},
               "top": sorted(by_name.items(), key=lambda x: -x[1][1])[:15]}
    print(f"[profile] window {summary['window_ms']:.3f} ms over {passes} x {unit}; device busy "
          f"{summary['busy_ms']:.3f} ms, idle share {summary['idle_share']:.4f}; "
          f"{summary['kernels']} kernels, {summary['kernels_per_pass']:.1f} per {unit} "
          f"({len(device) - len(kernels)} host ranges on the device timeline left out)",
          flush=True)
    for cat, ms in summary["by_category_ms_per_pass"].items():
        print(f"[profile] device ms per {unit}: {cat:28s} {ms:.4f} "
              f"({summary['launches_per_pass'][cat]:.1f} launches)", flush=True)
    for name, (n, t) in summary["top"]:
        print(f"[profile] top: {t / 1e3:9.3f} ms  {n:6d} launches  {name[:110]}", flush=True)
    # The hand-written kernels' categories split by kernel name (a category
    # such as K4 may launch several kernels a call).
    for name, (n, t) in sorted(by_name.items(), key=lambda x: -x[1][1]):
        cat = _category(name)
        if "(K" in cat or "(kernel" in cat:
            print(f"[profile] split {cat}: {t / 1e3 / passes:.4f} ms per {unit}, "
                  f"{n / passes:.1f} launches, {t / n:.2f} us a launch  {name[:90]}",
                  flush=True)
    return summary


def _profile_train(dev, card: str, out_dir: str, cfg, batch_size: int = 32) -> None:
    from pepflowww_torch.config import DEFAULT_TRAIN
    from pepflowww_torch.training.optim import Optimizer
    from pepflowww_torch.training.train_step import train_step

    tc = DEFAULT_TRAIN
    batch, _ = main_path_batch(dev, batch_size)
    gen = torch.Generator(device=dev).manual_seed(1)
    runs = {}
    for name, kernels in (("kernels", True), ("plain", False)):
        model = production_model(dev, cfg, kernels).train()
        runs[name] = (model, Optimizer(model.parameters(), tc["optimizer"], tc["max_grad_norm"]))

    def steps(name, n):
        model, opt = runs[name]
        for _ in range(n):
            train_step(model, opt, batch, tc["loss_weights"], gen)

    for name in runs:
        steps(name, 3)  # warm-up: kernel build, cuBLAS handles, caches
    per_step = {name: [] for name in runs}
    for _ in range(3):
        for name in ("kernels", "plain", "plain", "kernels"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            steps(name, 10)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0) / 10
            per_step[name].append(ms)
            print(f"[profile] train {name:7s} B={batch_size} L=64: {ms:.3f} ms/step, "
                  f"{1e3 * batch_size / ms:.3f} samples/s on {card}", flush=True)
    for name, v in per_step.items():
        print(f"[profile] train {name:7s} median of {len(v)}: {np.median(v):.3f} ms/step, "
              f"{1e3 * batch_size / np.median(v):.3f} samples/s (min {min(v):.3f}, max "
              f"{max(v):.3f}) on {card}", flush=True)
    profile_window(lambda: steps("kernels", 3), 3, out_dir, unit="train step", name="train")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default=os.path.join("configs", "learn_angle_tpu.yaml"))
    ap.add_argument("--out", default=os.path.join("chiprun_out", "profile"))
    ap.add_argument("--train", action="store_true", help="profile the training step")
    ap.add_argument("--batch_size", type=int, default=64, help="the sampler's batch")
    ap.add_argument("--complex", type=int, nargs=3, default=(12, 48, 64),
                    metavar=("PEP", "REC", "PAD"),
                    help="the sampler's complexes: peptide and pocket lengths, padded length")
    args = ap.parse_args(argv)
    batch_size, steps, L = args.batch_size, 100, args.complex[2]

    dev = resolve_device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[profile] card: {card}; torch {torch.__version__}, cuda {torch.version.cuda}",
          flush=True)
    cfg = load_config(args.config)
    ipa = cfg.ipa
    print(f"[profile] config {args.config}: {ipa.num_blocks} blocks, dtype {ipa.dtype}, "
          f"use_pallas {ipa.use_pallas}, use_pallas_ipa {ipa.use_pallas_ipa}, "
          f"quant_int8 {ipa.quant_int8}", flush=True)
    if args.train:
        _profile_train(dev, card, args.out, cfg)
        return
    models = {"kernels": production_model(dev, cfg, True),
              "plain": production_model(dev, cfg, False)}
    batch, _ = main_path_batch(dev, batch_size, complex_=tuple(args.complex))
    for m in models.values():
        _timed_run(m, batch, 2, 0)  # warm-up: kernel build, cuBLAS handles, caches
    secs = {name: [] for name in models}
    for _ in range(3):
        for name in ("kernels", "plain", "plain", "kernels"):
            sec = _timed_run(models[name], batch, steps, 1)
            secs[name].append(sec)
            print(f"[profile] {name:7s} B={batch_size} L={L} steps={steps}: {sec:.4f} s, "
                  f"{batch_size / sec:.3f} peptides/s on {card}", flush=True)
    for name, s in secs.items():
        print(f"[profile] {name:7s} median of {len(s)}: {np.median(s):.4f} s, "
              f"{batch_size / np.median(s):.3f} peptides/s (min {min(s):.4f} s, "
              f"max {max(s):.4f} s) on {card}", flush=True)
    model = models["kernels"]
    profile_window(lambda: euler_sample(model, batch, torch.Generator(device=dev).manual_seed(7),
                                        num_steps=5), 5, args.out,
                   unit="denoise pass (one encode included)")


if __name__ == "__main__":
    main()
