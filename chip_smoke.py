#!/usr/bin/env python
"""Smoke run of the PyTorch port (``pepflowww_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each on its own lines:

1. setup: the card's name and power limit, torch/CUDA versions, and the
   build of every CUDA kernel from ``pepflowww_torch/csrc`` (one ``nvcc``
   per source, all at once); ``ptxas -v``'s registers and spills, and the
   dynamic shared memory, of both variants of the EdgeTransition kernels
   (K1/K2 and K6), of the six of the fused IPA forward (K7), of the five
   kernels of its backward (K8: the tile and pair kernels of L <= 64, the
   query, key and pair kernels of L > 64), of the three kernels of the
   EdgeTransition backward (K4) and of the distance kernels (K3; K5's main
   and reduction kernels) and of the four variants of the v1 attention
   core's tensor-core kernel (K9), none of which may spill; K8's, K3's and
   K5's launches a call, and K3's and K5's blocks an SM.
2. kernels: each kernel's wrapper on the card against its plain PyTorch
   version, at the sampler's flagship shapes (B=64, L=64, c_s 128, c_z 64)
   and at a ragged L, with the max abs error beside the tolerance and the
   kernel's, the plain version's and the bound's times; K1/K2 and K6 also
   at (B, L) = (3, 37), (1, 1), (2, 100) and (64, 128), readout on and off;
   the backward kernels at the training shapes (B=32, L=64) and a ragged
   L (K4 also at B=3, L=37), each called twice to show bit-identical
   gradients, and the forward EdgeTransition (readout off, as in training)
   timed at B=32. The distance kernels also at (B, L) = (3, 37), (1, 1),
   (2, 100) (K3 also at (64, 128)) and on a B=32, L=64 batch whose tokens
   are all one value. The fused IPA forward (K7) at B=64
   and L=64, 40 and 256 in the sampler's input layouts, at (B, L) = (1, 1),
   (3, 37), (2, 100), (64, 128) in the sampler's and the training step's,
   and at B=32, L=64 in the training step's, with both layouts' times; its
   backward (K8) in the training step's layouts at B=32 and L=64, 24, 128,
   160 and 256 (each timed) and at (B, L) = (3, 37), (1, 1), (2, 100), (3,
   65), with its launches a call (2 at L <= 64, 3 above). The int8
   EdgeTransition (K6) at B=64, L=64 with the readout on and off and at
   L=40. The v1 IPA attention core (K9), through both of its wrappers: bf16
   at the model's widths (the tensor-core kernel) at B=64 and L = 64, 24,
   100, 128, 256 and at B=2, L=1, timed on the device at L = 64, 128, 256;
   fp32 at the JAX tests' widths (the fp32 kernel) at L=40 and 256; each
   call one launch of its kernel (the library's count of each kernel).
3. oracle: the bf16 sampler with the kernels, weights of the trained nb=6
   reference oracle (``tests/golden/sampler_stats_trained6.npz``) loaded
   strict, its 64x24 batch for its 25 steps and 3 seeds pooled; AAR and
   translation norm within the 2-sigma bounds of
   tests/test_sampler_parity.py, and the launch counts of the kernels; then
   the same with the fused IPA (``use_pallas_ipa``) on. Then the int8
   serving profile (``quant_int8``): the JAX package's own int8 gate (the
   trained nb=2 oracle ``sampler_stats_trained.npz``, seeds 29/30/31
   pooled, tests/test_sampler_parity.py:237-275) and the nb=6 gate.
4. main: the production sampler (configs/learn_angle_tpu.yaml: 6 blocks,
   c_s 128, c_z 64, bf16, kernels on) on B=64, L=64 synthetic complexes
   (48-residue pocket + 12-residue peptide) for 100 steps with seeded random
   weights; peptides/s, the launch counts, and well-formed PDBs. Then the
   fused-IPA profile (the same YAML with ``use_pallas_ipa: true``) on the
   same workload: K7 600 times, K2 500, K3 once. Then the int8 serving
   profile (the YAML with ``quant_int8: true``), this slice's main path:
   K6 500 times, K3 once and no other kernel, peptides/s beside the
   production profile's.
5. train: the production profile's training step at B=32 (the config's
   batch_size), L=64 synthetic batches, seeded weights: launches per step
   (5 EdgeTransition forward and backward, 1 distance forward and backward),
   a finite gradient for every parameter, the kernel step's gradients
   against the same step through the plain versions, 30 Adam steps on one
   batch and one draw lowering the loss, and ms/step and samples/s over 20
   timed steps. Then the same for the fused-IPA profile (6 K7 and 6 K8
   launches besides those), and its step at L=128 (116-residue pockets and
   12-residue peptides: K8 through its three kernels of L > 64; launches,
   gradients against the plain step, ms/step over 10 steps beside L=64's).
   Then a training step of the int8 profile must raise its forward-only
   error, with no EdgeTransition launched.
6. data: six complexes written as a PepMerge-style directory
   (``chiprun_out/structs/<id>/{peptide.pdb,pocket.pdb}``) whose padded
   lengths cover the buckets 32, 48, 64, 96, 128 and 160, with a 3-residue
   and a 25-residue peptide and, in the L=160 complex, three pocket
   residues without their side-chain atoms; preprocessed by the port's
   ``PepDataset`` (a spawned process pool) into ``chiprun_out/cache``. The
   L=160 item replicated to B=16 goes through encode and one denoise pass
   at t=0.5 with the kernels on, the same noised seed weights, every output
   within DATA_TOL of the same path with the kernels' plain versions (the
   kernels off, and float32, printed beside it). Then the sample CLI
   (``pepflowww_torch.sample.main``) in-process on the card: the production
   profile, 32 samples a complex, 100 steps, with seed-initialized weights;
   EdgeTransition (K2) 3000 launches and distance (K3) 6, no other kernel;
   ``outputs.csv`` with 192 finite rows, ``summary.json``, well-formed
   PDBs, and peptides/s per bucket. Then the port bench's measurement
   (``pepflowww_torch.bench``) at L64_B64 with one timed run, and the keys
   of its line.
7. train data: a PepMerge-style training directory of 66 complexes (33 in
   each of the buckets 64 and 128, peptides of 3-25 residues, three pocket
   residues of one 128-bucket complex without side chains) and a
   validation directory of 40 (20 in each of the buckets 48 and 160),
   preprocessed into ``chiprun_out/train_cache`` with an exclusion file
   naming one training id of each bucket (they must be missing: 32 a
   bucket stay). The train CLI (``pepflowww_torch.train.main``) in-process
   on the card with the production profile, B=32, 12 iterations,
   validation every 6 (two ragged batches of 20) and a log line every 2,
   with ``--profile_dir`` (a trace with device kernels); then ``--resume``
   for 2 more iterations from iteration 13; then the same for the
   fused-IPA profile. Each run: finite losses, ``val it 6`` and ``val it
   12``, checkpoints 6 and 12, ``commit.txt``, and launches equal to the
   steps times a step's (K1 5, K4 5, K3 1, K5 1; K7 6 and K8 6 fused) plus
   the validation forwards times a forward's (K1 5, K3 1; K7 6 fused). The
   kernel step's gradients against the plain step on the loader's real
   128-bucket batch (padding rows, partial atom masks) in both profiles.
   Printed, not gated: ms/step, samples/s and peak memory per bucket, and
   the padding comparison in one call: the loader's bucketed batches
   against the same items in unbucketed batches padded to their longest
   item rounded up to 8 (the reference's rule), with the padding waste
   (padded / real - 1), 10 training steps each in turns.
8. dp: data parallelism (``pepflowww_torch/parallel``) at full width, the
   production profile. The train CLI in-process with ``--dp``, a world of
   one over NCCL, synthetic B=32, L=64, 6 iterations, validation and a
   checkpoint at 6, then the same without ``--dp``: launches equal 6 steps
   (K1 5, K4 5, K3 1, K5 1) plus 2 validation forwards (K1 5, K3 1) in
   each, the losses of the two runs within DP_RTOL of each other at every
   iteration (the largest gap printed), one run directory with its
   checkpoint; the fused-IPA profile with ``--dp`` for 3 iterations (K7 6
   and K8 6 a step besides). ms/step of iterations 2-6 of the two
   production runs, from their samples/s (printed). Then two
   ranks spawned on the one card over gloo, B=16 each, in both training
   profiles: each rank's launches exact, the reduced gradients
   bit-identical on both ranks, the loss and grad_norm within DP_RTOL of
   one process's step at B=32 with the same weights and global noise and
   each gradient within STEP_REL/STEP_ABS of its; and ``dp_euler_sample``
   of two complexes x 3 samples (padded to 4 rows) with K2 and K3
   launches exact on each rank. The sample CLI with ``--dp`` (a world of
   one): 3 rows a complex in ``outputs.csv``, K2 and K3 exact. The server
   as a process with ``--dp``: /healthz names the world size and the card,
   4 clients x 2 requests x 8 samples all answered, K2 500 and K3 1 a
   group on rank 0 (its log), and a SIGTERM that ends it with code 0.
   Outputs: chiprun_out/{dp_logs,dp_samples}.
9. fsdp_tp: FSDP and pair-row TP (``parallel/fsdp.py``, ``parallel/tp.py``)
   at full width. The train CLI in-process with ``--fsdp``, a world of one
   over NCCL: launches exact as the dp phase's (6 steps and 2 validation
   forwards; the fused-IPA profile 3 and 2), the losses within FSDP_RTOL of
   the dp phase's unsharded runs at every iteration; with ``--tp 1`` the
   JAX rule's warning, no kernel launched, and the losses within FSDP_RTOL
   of a ``use_pallas: false`` run's. Then two ranks spawned on the one card
   over gloo (gloo must take CUDA tensors in the all-gather and the
   reduce-scatter; a refusal fails the phase with its message): ``--fsdp``
   at B=16 each against one process at B=32 (loss and grad_norm within
   DP_RTOL, every gradient within STEP_REL/STEP_ABS; a rank's block and moments, 12 bytes an element of
   its block, and its ``memory_allocated`` at most 0.55 of one
   process's; no storage behind the whole parameters); ``--tp 2`` at B=32
   L=128, the plain profile, against one process (the same limits; every
   EdgeTransition and IPA fed (32, 64, 128, 64); peak memory a rank beside
   one process's, printed); the TP sampler of the fp32 plain profile
   against one process's at the same seed (trans and rotations within
   5e-5, tokens equal). The server as a process with ``--tp 1``: its
   warning, /healthz with the grid, one request of 8 samples × 20 steps
   answered with no kernel launched, SIGTERM exit 0. Outputs:
   chiprun_out/fsdp_tp_logs.
10. pp: GPipe pipeline parallelism (``parallel/pp.py``) at full width and
   depth. Two processes on the one card first probe whether gloo's send
   and recv take CUDA tensors (printed either way: the port's stage hops
   over a gloo group go through host buffers by its backend, NCCL's take
   device tensors). Then ``--pp 2`` over two ranks sharing the card over
   gloo (the production YAML, which becomes the plain profile with the
   JAX rule's warning, 3 blocks a stage, B=32 L=128, 4 microbatches): one
   step against one process's plain-profile step on the same rows and
   noise (loss and grad_norm within DP_RTOL, every gradient within
   STEP_REL/STEP_ABS), no kernel launched, the hop transport, each rank's
   peak memory beside one process's, and a second step's seconds. Then
   ``--pp 2 --fsdp`` over four ranks (2 data x 2 pipe, B=16 a data rank)
   against the same process: the loss within DP_RTOL, the state a rank
   (12 bytes an element of its block). Last, the train CLI on this
   one-GPU world: ``--pp 2`` exits with "must divide the world size" and
   ``--pp 2 --tp 2`` with the JAX CLI's words.
11. eval: ``pepflowww_torch.evalrun`` in-process over the data phase's
   samples (6 complexes x 32 PDBs) against its structures, with ``--tools
   ss`` (the Ramachandran fallback) and ``--tools auto``: 192 rows with a
   finite ``ss_recovery``, every absent tool recorded as unavailable, the
   wall time, and no kernel launched.
12. serve: ``python -m pepflowww_torch.serve --synthetic_weights --port 0``
   as a process with the production YAML (its address read from its
   output): ``/healthz`` names cuda and the card, a request without a
   native peptide (12 residues, 2 samples, 100 steps) returns 2 PDBs with
   12 residues in chain A, a garbage pocket returns 400 with an error.
   Then in-process, the production profile with seeded weights: the warm
   ladder of bucket 64 (sizes 1 … 64, each group K2 500 times and K3 once,
   nothing else), size 1 again warm; the port's load test
   (``serve_loadtest``, 8 clients x 2 requests x 8 samples, 100 steps,
   bucket 64) with 0 errors and launches equal to 500 K2 and 1 K3 a group
   run, every response's PDBs checked as the server sends them; 8 requests
   at bucket 32 and 8 at 128 sent together (every row once, each response
   its own complex); one request of 100 samples (one group padded to 128,
   two 64-row chunks: K2 1000, K3 2, 100 PDBs). Then a burst of 4 clients
   x 2 requests x 8 samples in the int8 profile (K6 500 and K3 1 a group)
   and the fused-IPA profile (K7 600, K2 500, K3 1). Last, the kernels at
   the server's shapes against their plain versions: K2 and K3 at B = 1,
   2, 4 and 16 in the buckets 32, 64 and 128 (on those buckets'
   complexes), K6 and K7 at B = 8, 16 and 32 in bucket 64. Printed:
   seconds a ladder size, peptides/s and latencies beside the main phase's
   figure, the merged group sizes, K2's and K3's device time a call at
   B = 1, 2, 4 in bucket 64.
13. widths: the production profile at the JAX package's 2x, 4x and 8x
   widths (c_z = F = 128, 256, 512, ``tools/width_sweep.py``'s
   configuration, B = 64, 32, 8 at L = 64). For each width, K1-K5 through
   their wrappers against their plain versions (K1/K2 within EDGE_TOL, K3
   within DIST_TOL, K4 and K5 each gradient within BWD_REL of its norm and
   bit-identical across two calls), the device kernels of one call (the
   library's count, by design 5, 6, 4, 20 and 15), each one's device time beside
   its bound; then the 6-block model of that width with seeded weights
   through the normal entry points: a 20-step sampler run (K2 100 times, K3
   once, nothing else) and a training step (K1 5, K4 5, K3 1, K5 1) with
   finite outputs and gradients, and the width sweep's row
   (``width_sweep.run_width``: train ms/step, samples/s, MFU, sampler
   peptides/s at 100 steps) beside the card's name and power limit.

The kernels' JSON line gives each kernel's launches on its path's run: the
EdgeTransition forward with the readout (K2) and the distance forward
kernel on the production sampler's, the EdgeTransition forward without it
(K1, its own entry ``edge_transition_k1``, same counter) and the backward
kernels on the production training step's, K7 on the fused-IPA sampler's,
K8 on the fused-IPA training step's (``ipa2_bwd`` at L=64, its own entry
``ipa2_bwd_long`` at L=128, same counter) and K6 on the int8 sampler's. K9 has
no model path in either package: its launches are the kernels phase's
checks. K2, K3, K6 and K7 also give ``serve_launches``: their launches in
the serve phase's in-process runs (the CLI's process counts its own). The
kernels of the dp phase give ``dp_launches`` and ``dp_run``, their
launches in its run named there (K2 and K3 the sample CLI's, K1, K4 and
K5 the production train CLI's, K7 and K8 the fused-IPA train CLI's), and
K2 and K3 ``dp_serve_launches``, rank 0's in the ``--dp`` server. Every
kernel gives ``fsdp_launches``, its launches in the fsdp_tp phase's
``--fsdp`` train CLI runs (K1, K3, K4 and K5 the production one's, K7 and
K8 the fused-IPA one's; the others none: the step has no readout), and
``tp_launches``, its launches in every ``--tp`` run of that phase (none:
the model is built without its kernels), and ``pp_launches``, its launches
in the pp phase's ranks (none: ``--pp`` builds the plain profile). K1-K5
(``edge_transition_k1``, ``edge_transition``, ``distance_embed``,
``edge_transition_bwd``, ``distance_embed_bwd``) also give ``widths``: by
width, the launches of the widths phase's model runs (K2 and K3 the
sampler's, K1, K4 and K5 the training step's) and the kernel's error,
times and bound at that width.

Prints the kernels' JSON line and the card's line before the last, and as
the last line ``{"ok": true, "device": {...}}``. Any failed check exits
non-zero before that line. Without CUDA, or without the package beside
this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import glob
import json
import math
import os
import re
import signal
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")


EDGE_TOL = (6e-2, 2e-2)    # (atol, rtol): bf16 output, hidden layers rounded to bf16
DIST_TOL = (3e-2, 2e-2)    # (atol, rtol): bf16 output of a 2-layer MLP
# Backward kernels: each gradient within this fraction of the plain
# gradient's norm. They are sums over every pair of products of bf16-rounded
# operands; a rounding that flips between kernel and plain version moves one
# term by one bf16 step, a wrong index or a lost partial moves the whole sum.
BWD_REL = 1e-2
# Train step, kernels against plain versions (same rounding points, bf16):
# per parameter ||dg|| <= STEP_REL ||g|| + STEP_ABS * global norm. Roundings
# that flip in the pair track move the trunk's inputs by one bf16 step, and
# gradients reached only through the attention's pair bias are small, so
# their error has a floor set by the global norm.
STEP_REL, STEP_ABS = 5e-2, 1e-3
# Fused IPA forward, fp32 outputs: |kernel - plain| <= atol + rtol |plain|.
# A bf16 rounding of an attention weight that flips between kernel and
# plain version moves the scalar output by at most 2^-9 |v|; the logits,
# softmax and point sums run in fp32 in another order.
IPA_TOL = (2e-2, 1e-3)
# K9 with fp32 inputs at the JAX tests' widths: the same sums in another order.
IPA1_FP32_TOL = (1e-3, 1e-4)
# The production model at L=160, B=16, the kernels against their plain
# versions on the same path (the same weights and flags), max abs error of
# each output of encode and of one denoise pass: about three times this
# gate's readings on the H100 (node 0, no kernel on its path; edge 9.8e-4,
# one bf16 step of K3's output; rot 1.62e-2, trans 1.04e-2, angles 2.9e-3,
# logits 3.6e-3, one-step bf16 flips of K2 and K3 carried through six
# blocks), capped at tests/test_torch_bf16.py's bounds for the port against
# JAX.
DATA_TOL = {"node": 1e-6, "edge": 3e-3, "rot": 2e-2, "trans": 1.5e-2, "angles": 9e-3,
            "logits": 1e-2}
# (peptide, pocket) lengths of the data phase's complexes: padded to 32, 48,
# 64, 96, 128 and 160; the L=160 one loses three side chains.
DATA_SIZES = ((3, 25), (25, 18), (12, 48), (10, 80), (14, 106), (20, 135))
# The train data phase's directories: (bucket, complexes) with peptides of
# 3-25 residues; one complex of each training bucket is excluded, leaving 32
# in each (one batch of the config's B=32); the validation split's batches
# are ragged (20 of 32).
TRAIN_SPEC = ((64, 33), (128, 33))
VAL_SPEC = ((48, 20), (160, 20))
SUMMARY_KEYS = {"num_complexes", "avg_best_rmsd", "avg_median_rmsd", "avg_mean_ca_rmsd",
                "avg_mean_aar", "avg_mean_tm_score", "avg_best_tm", "success_rate_2A",
                "success_rate_5A"}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def exp_floor_ms(B: int, L: int) -> float:
    """The least time of the distance block's 225 exps a pair on the
    special function units: 16 a clock an SM (bounds.py counts an exp as one
    fp32 operation and does not see this), at the card's SM count and its
    maximum SM clock as nvidia-smi reads it."""
    import torch

    res = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    mhz = float(res.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return 1e3 * B * L * L * 225 / (16 * sms * mhz * 1e6)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of `fn` over `reps` calls (CUDA events, after warm-up)."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(name: str, got, want, tol, phase: str = "kernels") -> float:
    import torch

    atol, rtol = tol
    got, want = got.float(), want.float()
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite kernel output")
    err = (got - want).abs()
    worst = float((err - rtol * want.abs()).max())
    max_abs = float(err.max())
    say(phase, f"{name}: max_abs_err={max_abs:.3e} (tolerance atol {atol} + rtol {rtol}"
                   f" x |plain|; worst excess {worst:.3e})")
    check(worst <= atol, f"{name}: kernel disagrees with its plain version")
    return max_abs


# ---------------------------------------------------------------- phases
def phase_setup():
    import torch

    from pepflowww_torch import native

    card = card_line()
    say("setup", f"card: {card}")
    say("setup", f"python {sys.version.split()[0]}, torch {torch.__version__}, "
                 f"cuda {torch.version.cuda}, device {torch.cuda.get_device_name(0)} "
                 f"x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    secs = native.build_all()
    say("setup", f"built {sorted(secs)} in {time.perf_counter() - t0:.1f} s "
                 f"({', '.join(f'{k} {v:.1f} s' for k, v in secs.items())})")
    for name, log in native.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                say("setup", f"ptxas {name}: {line.strip()}")
    # K1/K2 and K6: registers, spills and shared memory of both variants of
    # each (readout off, on: template argument false, true); no spills allowed.
    for lib, kernel, tags in (("edge_transition", "edge_transition_kernel", ("K1", "K2 (readout)")),
                              ("edge_transition_int8", "edge_int8_kernel", ("K6", "K6 (readout)"))):
        variants = [(tags["ILb1E" in entry], use, spill)
                    for entry, use, spill in ptxas_entries(native.BUILD_LOG.get(lib, ""))
                    if kernel in entry]
        check(len(variants) == 2, f"{lib}: ptxas -v reported no entry for both variants")
        smem = native.function(lib, f"{lib}_smem_bytes", [])()
        for tag, use, spill in variants:
            say("setup", f"{lib} {tag}: {use}; {spill}; {smem} bytes of dynamic shared memory "
                         f"a block")
            check(spill.startswith("0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
                                   "loads"), f"{lib} {tag}: the consumer path spills ({spill})")
    # K7: every variant (the sampler's layout, training's, strided loads;
    # each for one key tile or several); no spills.
    variants = [(re.search(r"ipa2_fwd_kernelILb(\d)ELi(\d)ELb(\d)E", entry), use, spill)
                for entry, use, spill in ptxas_entries(native.BUILD_LOG.get("ipa2", ""))
                if "ipa2_fwd_kernel" in entry]
    check(len(variants) == 6 and all(m for m, _, _ in variants),
          "ipa2: ptxas -v reported no entry for each K7 variant")
    smem = native.function("ipa2", "ipa2_smem_bytes", [])()
    for m, use, spill in variants:
        tag = (f"bias {('strided', 'rows')[int(m[1])]}, pair {('j', 'd', 'strided')[int(m[2])]}, "
               f"{('L <= 64', 'L > 64')[int(m[3])]}")
        say("setup", f"ipa2 K7 ({tag}): {use}; {spill}; {smem} bytes of dynamic shared memory "
                     f"a block")
        check(spill.startswith("0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"),
              f"ipa2 K7 ({tag}) spills ({spill})")
    # K9: the tensor-core kernel's four variants (the bias tile copied as rows
    # or read in place; one key tile or several); no spills.
    variants = [(re.search(r"ipa1_hopper_kernelILb(\d)ELb(\d)E", entry), use, spill)
                for entry, use, spill in ptxas_entries(native.BUILD_LOG.get("ipa1", ""))
                if "ipa1_hopper_kernel" in entry]
    check(len(variants) == 4 and all(m for m, _, _ in variants),
          "ipa1: ptxas -v reported no entry for each K9 variant")
    smem = native.function("ipa1", "ipa1_smem_bytes", [])()
    for m, use, spill in variants:
        tag = f"bias {('in place', 'rows')[int(m[1])]}, {('L <= 64', 'L > 64')[int(m[2])]}"
        say("setup", f"ipa1 K9 ({tag}): {use}; {spill}; {smem} bytes of dynamic shared memory "
                     f"a block")
        check(spill.startswith("0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"),
              f"ipa1 K9 ({tag}) spills ({spill})")
    # K8: the tile and pair kernels of L <= 64 and the query, key and pair
    # kernels of L > 64; no spills.
    kinds = {"tile": 0, "pairs": 1, "query": 2, "key": 3, "pair": 4}
    entries = [(re.search(r"ipa2_bwd_(tile|pairs|query|key|pair)_kernel", entry), use, spill)
               for entry, use, spill in ptxas_entries(native.BUILD_LOG.get("ipa2_bwd", ""))
               if "ipa2_bwd_" in entry]
    check(sorted(m[1] for m, _, _ in entries if m) == sorted(kinds) and len(entries) == len(kinds),
          "ipa2_bwd: ptxas -v reported no entry for each K8 kernel")
    smem = native.function("ipa2_bwd", "ipa2_bwd_smem_bytes", [ctypes.c_int] * 2)
    for m, use, spill in entries:
        say("setup", f"ipa2_bwd K8 ({m[1]}): {use}; {spill}; {smem(kinds[m[1]], 8)} bytes of "
                     f"dynamic shared memory a block at H=8")
        check(spill.startswith("0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"),
              f"ipa2_bwd K8 ({m[1]}) spills ({spill})")
    per_call = native.function("ipa2_bwd", "ipa2_bwd_kernels_per_call", [ctypes.c_int])
    check((per_call(64), per_call(65)) == (2, 3), "ipa2_bwd: not 2 launches a call for L <= 64 "
                                                  "and 3 above")
    say("setup", f"ipa2_bwd K8 launches a call: {per_call(64)} for L <= 64, {per_call(65)} "
                 f"for L > 64")
    # K3 and K5: the forward kernel, the backward's main and reduction
    # kernels; no spills; each one's launches a call and blocks an SM.
    for lib, tag, names in (("distance_embed", "K3", ("distance_embed_kernel",)),
                            ("distance_embed_bwd", "K5", ("dist_bwd_kernel",
                                                          "dist_bwd_reduce_kernel"))):
        entries = [(m[1], use, spill)
                   for entry, use, spill in ptxas_entries(native.BUILD_LOG.get(lib, ""))
                   if (m := re.search(r"\d(" + "|".join(names) + ")E", entry))]
        check(sorted(n for n, _, _ in entries) == sorted(names),
              f"{lib}: ptxas -v reported no entry for each {tag} kernel")
        smem = native.function(lib, f"{lib}_smem_bytes", [])()
        for name, use, spill in entries:
            extra = f"; {smem} bytes of dynamic shared memory a block" if name != \
                "dist_bwd_reduce_kernel" else ""
            say("setup", f"{lib} {tag} {name}: {use}; {spill}{extra}")
            check(spill.startswith("0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
                                   "loads"), f"{lib} {tag} {name} spills ({spill})")
        per_call = native.function(lib, f"{lib}_kernels_per_call", [])()
        per_sm = native.function(lib, f"{lib}_blocks_per_sm", [])()
        say("setup", f"{lib} {tag} launches a call: {per_call}; blocks of its main kernel an "
                     f"SM: {per_sm}")
    # K4: its chain, weight-gradient and reduction kernels; no spills.
    entries = [(re.search(r"edge_bwd_\w+?_kernel", entry), use, spill)
               for entry, use, spill in ptxas_entries(native.BUILD_LOG.get("edge_transition_bwd", ""))
               if "edge_bwd_" in entry]
    check(len(entries) == 3 and all(m for m, _, _ in entries),
          "edge_transition_bwd: ptxas -v reported no entry for each K4 kernel")
    for m, use, spill in entries:
        say("setup", f"edge_transition_bwd K4 {m[0]}: {use}; {spill}")
        check(spill.startswith("0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"),
              f"edge_transition_bwd K4 {m[0]} spills ({spill})")
    # The wide kernels (c_z = F = 128, 256, 512; csrc/wide_gemm.cuh, wide_dist.cuh) of each
    # library: the tiled GEMM's instances (tile, operand layout, epilogue) and the row
    # kernels; no spills. The GEMM's dynamic shared memory: three stages of its A and B
    # tiles, rows padded by 16 bytes.
    modes = ("relu", "relu+pair mask", "fp32", "residual", "dA", "dA2 (distance)", "dx",
             "readout", "split-K partial")
    for lib, tag in (("edge_transition", "K1/K2"), ("edge_transition_bwd", "K4"),
                     ("distance_embed", "K3"), ("distance_embed_bwd", "K5")):
        entries = [(re.search(r"(wide_\w+?_kernel)(?:ILi(\d+)ELi(\d+)ELb(\d)ELi(\d+)E)?", entry),
                    use, spill) for entry, use, spill in ptxas_entries(native.BUILD_LOG.get(lib, ""))
                   if "wide_" in entry]
        check(any(m and m[2] for m, _, _ in entries), f"{lib}: ptxas -v reported no wide GEMM")
        for m, use, spill in entries:
            extra = ""
            if m[2]:
                bm, bn, tt, mode = int(m[2]), int(m[3]), m[4] == "1", int(m[5])
                smem = 3 * 2 * (64 * (bm + bn + 16) if tt else 72 * (bm + bn))
                extra = (f" {bm}x{bn} {'TT' if tt else 'NT'} {modes[mode]}; {smem} bytes of "
                         f"dynamic shared memory a block")
            say("setup", f"{lib} {tag} wide {m[1]}{extra}: {use}; {spill}")
            check(spill.startswith("0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
                                   "loads"), f"{lib} {tag} wide {m[1]} spills ({spill})")
    return card


def ptxas_entries(log: str):
    """(entry function, its "Used ... registers" line, its stack and spill
    line) for each kernel in a ``ptxas -v`` log."""
    entries = []
    for line in (s.strip() for s in log.splitlines()):
        if "Compiling entry function" in line:
            entries.append([line.split("'")[1], "", ""])
        elif entries and "spill" in line:
            entries[-1][2] = line
        elif entries and "registers" in line:
            entries[-1][1] = line.split(":", 1)[1].strip()
    return entries


def _edge_inputs(B, L, dev, seed):
    import torch

    g = torch.Generator(device="cpu").manual_seed(seed)
    r = lambda *s, sc=1.0: (torch.randn(*s, generator=g) * sc).to(dev)
    p = {"k1": r(192, 192, sc=0.1), "b1": r(192, sc=0.1), "k2": r(192, 192, sc=0.1),
         "b2": r(192, sc=0.1), "k3": r(192, 64, sc=0.1), "b3": r(64, sc=0.1),
         "ln_scale": 1 + r(64, sc=0.1), "ln_bias": r(64, sc=0.1)}
    readout = (r(64, 8, sc=0.1), r(8), r(64, 16, sc=0.1), r(16))
    edge = r(B, L, L, 64).bfloat16()
    node_bias = r(B, L, 64).bfloat16()
    mask = (torch.rand(B, L, generator=g) > 0.1).float().to(dev)
    return edge, node_bias, mask, p, readout


def phase_kernels():
    import numpy as np
    import torch

    from pepflowww_torch import native
    from pepflowww_torch.bounds import (dist_bound_ms, dist_bwd_bound_ms, edge_bound_ms,
                                        edge_bwd_bound_ms, edge_int8_bound_ms, ipa2_bound_ms,
                                        ipa2_bwd_bound_ms, ipa_v1_bound_ms)
    from pepflowww_torch.data.collate import device_batch
    from pepflowww_torch.data.synthetic import make_batch
    from pepflowww_torch.kernel_times import device_ms
    from pepflowww_torch.models import cuda_dist, cuda_edge, cuda_ipa, cuda_ipa1

    dev = torch.device("cuda", 0)
    rows = {}
    # Kernel B: EdgeTransition, readout off and on, flagship and ragged L.
    for L in (64, 24):
        edge, nb, mask, p, ro = _edge_inputs(64, L, dev, seed=L)
        ops = cuda_edge.kernel_operands(p, ro)
        for with_ro in (False, True):
            r = ro if with_ro else None
            tag = f"edge_transition{'+readout' if with_ro else ''} B=64 L={L}"
            before = native.LAUNCHES["edge_transition"]
            got = cuda_edge.fused_edge_transition(edge, nb, mask, p, readout=r, ops=ops)
            torch.cuda.synchronize()
            check(native.LAUNCHES["edge_transition"] == before + 1, f"{tag}: no launch counted")
            want = cuda_edge.edge_transition_plain(edge, nb, mask, p, torch.bfloat16, r)
            got, want = (got, want) if with_ro else ((got,), (want,))
            err = max(compare(f"{tag} [{n}]", a, b, EDGE_TOL)
                      for n, a, b in zip(("out", "b", "pz"), got, want))
            k_ms = cuda_ms(lambda: cuda_edge.fused_edge_transition(edge, nb, mask, p, readout=r,
                                                                   ops=ops))
            p_ms = cuda_ms(lambda: cuda_edge.edge_transition_plain(edge, nb, mask, p,
                                                                   torch.bfloat16, r), reps=5)
            bound, by = edge_bound_ms(64, L, n_ro=24 if with_ro else 0)
            say("kernels", f"{tag}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
                           f"{bound:.4f} ms by {by} ({100 * bound / k_ms:.1f}% of bound)")
            if L == 64 and with_ro:
                rows["edge_transition"] = dict(err=err, ms=k_ms, plain_ms=p_ms, bound_ms=bound,
                                               bound_by=by)

    # Kernel A: distance embedding on the main path's synthetic complexes.
    for L, (rec, pep) in ((64, (48, 12)), (40, (28, 10))):
        bnp = make_batch(np.random.default_rng(L), batch_size=64, pep_len=pep, rec_len=rec,
                         pad_to=L)
        b = device_batch(bnp, dev)
        g = torch.Generator(device="cpu").manual_seed(L)
        r = lambda *s, sc: (torch.randn(*s, generator=g) * sc).to(dev)
        p = {"table": r(484, 225, sc=1.0), "k1": r(225, 64, sc=0.07), "b1": r(64, sc=0.1),
             "k2": r(64, 64, sc=0.12), "b2": r(64, sc=0.1)}
        smask = b["mask_heavyatom"][:, :, 1].float() * (~b["generate_mask"]).float()
        args = (b["pos_heavyatom"] * 0.1, b["mask_heavyatom"].float(), b["aa"], smask)
        ops = cuda_dist.kernel_operands(p)
        tag = f"distance_embed B=64 L={L}"
        before = native.LAUNCHES["distance_embed"]
        got = cuda_dist.fused_distance_embed(*args, p, ops=ops)
        torch.cuda.synchronize()
        check(native.LAUNCHES["distance_embed"] == before + 1, f"{tag}: no launch counted")
        want = cuda_dist.distance_embed_plain(*args, p, torch.bfloat16)
        err = compare(tag, got, want, DIST_TOL)
        k_ms = cuda_ms(lambda: cuda_dist.fused_distance_embed(*args, p, ops=ops))
        p_ms = cuda_ms(lambda: cuda_dist.distance_embed_plain(*args, p, torch.bfloat16), reps=5)
        bound, by = dist_bound_ms(64, L)
        say("kernels", f"{tag}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
                       f"{bound:.4f} ms by {by} ({100 * bound / k_ms:.1f}% of bound); the "
                       f"exps' floor on the special function units {exp_floor_ms(64, L):.4f} ms")
        if L == 64:
            rows["distance_embed"] = dict(err=err, ms=k_ms, plain_ms=p_ms, bound_ms=bound,
                                          bound_by=by)
    # K3 at the shapes that stress its walk: a ragged single j tile, L=1, two j
    # tiles with a ragged edge, L > 64 at the sampler's batch; and a batch
    # whose tokens are all one value (one run of aa_i across every block).
    for B, L, one in ((3, 37, False), (1, 1, False), (2, 100, False), (64, 128, False),
                      (32, 64, True)):
        args, p = _dist_inputs(B, L, dev, seed=800 + B * 1000 + L, one_token=one)
        tag = f"distance_embed B={B} L={L}{' (one token)' if one else ''}"
        got = _launch_once("distance_embed", lambda: cuda_dist.fused_distance_embed(*args, p), tag)
        compare(tag, got, cuda_dist.distance_embed_plain(*args, p, torch.bfloat16), DIST_TOL)
    # K1/K2 and K6 at the shapes that stress the tile mapping: a tile crossing
    # batch rows at a ragged L, L=1, fewer tiles than SMs, L > 64, readout on
    # and off.
    forwards = (("edge_transition", cuda_edge.fused_edge_transition,
                 cuda_edge.edge_transition_plain, False),
                ("edge_transition_int8", cuda_edge.fused_edge_transition_int8,
                 cuda_edge.edge_transition_int8_plain, True))
    for B, L in ((3, 37), (1, 1), (2, 100), (64, 128)):
        edge, nb, mask, p, ro = _edge_inputs(B, L, dev, seed=B * 1000 + L)
        for name, fwd, fwd_plain, int8 in forwards:
            ops = cuda_edge.kernel_operands(p, ro, quant_int8=int8)
            for r in (None, ro):
                tag = f"{name}{'+readout' if r else ''} B={B} L={L}"
                got = _launch_once(name, lambda: fwd(edge, nb, mask, p, readout=r, ops=ops), tag)
                want = fwd_plain(edge, nb, mask, p, torch.bfloat16, r)
                for n, a, b in zip(("out", "b", "pz"), got if r else (got,),
                                   want if r else (want,)):
                    compare(f"{tag} [{n}]", a, b, EDGE_TOL)
    # K1: the forward with readout off, as the training step runs it.
    edge, nb, mask, p, _ = _edge_inputs(32, 64, dev, seed=32)
    ops = cuda_edge.kernel_operands(p)
    tag = "edge_transition B=32 L=64 (training shape)"
    call = lambda: cuda_edge.fused_edge_transition(edge, nb, mask, p, ops=ops)
    plain = lambda: cuda_edge.edge_transition_plain(edge, nb, mask, p, torch.bfloat16)
    err = compare(tag, _launch_once("edge_transition", call, tag), plain(), EDGE_TOL)
    rows["edge_transition_k1"] = _time_row(tag, call, plain, edge_bound_ms(32, 64, n_ro=0), err)

    # Backward kernels at the training shape, a ragged L and (K4) a shape
    # whose 8 x 8 tiles are cut at both edges.
    for B, L in ((32, 64), (32, 24), (3, 37)):
        edge, nb, mask, p, _ = _edge_inputs(B, L, dev, seed=100 + L)
        g = _randn((B, L, L, 64), dev, 200 + L).bfloat16()
        ops = cuda_edge.kernel_operands(p)
        tag = f"edge_transition_bwd B={B} L={L}"
        call = lambda: cuda_edge.edge_transition_bwd(edge, nb, mask, p, g, ops=ops,
                                                     d_edge_dtype=torch.bfloat16)
        plain = lambda: cuda_edge.edge_transition_bwd_plain(edge, nb, mask, p, g, torch.bfloat16)
        got = _launch_once("edge_transition_bwd", call, tag)
        names = ("d_edge", "d_node") + cuda_edge.PARAM_NAMES
        flat = lambda r: (r[0], r[1], *(r[2][k] for k in cuda_edge.PARAM_NAMES))
        err = compare_grads(tag, names, flat(got), flat(plain()), flat(call()))
        row = _time_row(tag, call, plain, edge_bwd_bound_ms(B, L), err)
        if (B, L) == (32, 64):
            rows["edge_transition_bwd"] = row
    for L, (rec, pep) in ((64, (48, 12)), (40, (28, 10))):
        b = device_batch(make_batch(np.random.default_rng(300 + L), batch_size=32, pep_len=pep,
                                    rec_len=rec, pad_to=L), dev)
        p = {"table": _randn((484, 225), dev, L), "k1": _randn((225, 64), dev, L + 1) * 0.07,
             "b1": _randn((64,), dev, L + 2) * 0.1, "k2": _randn((64, 64), dev, L + 3) * 0.12,
             "b2": _randn((64,), dev, L + 4) * 0.1}
        smask = b["mask_heavyatom"][:, :, 1].float() * (~b["generate_mask"]).float()
        args = (b["pos_heavyatom"] * 0.1, b["mask_heavyatom"].float(), b["aa"], smask)
        g = _randn((32, L, L, 64), dev, 400 + L).bfloat16()
        ops = cuda_dist.kernel_operands(p)
        tag = f"distance_embed_bwd B=32 L={L}"
        call = lambda: cuda_dist.distance_embed_bwd(*args, p, g, ops=ops)
        plain = lambda: cuda_dist.distance_embed_bwd_plain(*args, p, g, torch.bfloat16)
        got = _launch_once("distance_embed_bwd", call, tag)
        flat = lambda r: tuple(r[k] for k in cuda_dist.PARAM_NAMES)
        err = compare_grads(tag, cuda_dist.PARAM_NAMES, flat(got), flat(plain()), flat(call()))
        row = _time_row(tag, call, plain, dist_bwd_bound_ms(32, L), err)
        say("kernels", f"{tag}: the exps' floor on the special function units (once an atom "
                       f"pair) {exp_floor_ms(32, L):.4f} ms")
        if L == 64:
            rows["distance_embed_bwd"] = row
    for B, L, one in ((3, 37, False), (1, 1, False), (2, 100, False), (32, 64, True)):
        args, p = _dist_inputs(B, L, dev, seed=850 + B * 1000 + L, one_token=one)
        g = _randn((B, L, L, 64), dev, 860 + B * 1000 + L).bfloat16()
        tag = f"distance_embed_bwd B={B} L={L}{' (one token)' if one else ''}"
        call = lambda: cuda_dist.distance_embed_bwd(*args, p, g)
        flat = lambda r: tuple(r[k] for k in cuda_dist.PARAM_NAMES)
        compare_grads(tag, cuda_dist.PARAM_NAMES, flat(_launch_once("distance_embed_bwd", call, tag)),
                      flat(cuda_dist.distance_embed_bwd_plain(*args, p, g, torch.bfloat16)),
                      flat(call()))

    # K7: the fused IPA forward, in the sampler's layouts; then both layouts at
    # the shapes that stress the tiling (L=1, a ragged single key tile, two
    # key tiles with a ragged edge, two full ones at the sampler's batch) and
    # at the training step's B=32.
    def ipa2_check(B, L, layout, seed):
        args = _ipa_inputs(B, L, dev, seed=seed, layout=layout)
        tag = f"ipa2 B={B} L={L} ({layout} layout)"
        got = _launch_once("ipa2", lambda: cuda_ipa.fused_ipa2(*args), tag)
        want = cuda_ipa.ipa2_plain(*args)
        return args, tag, max(compare(f"{tag} [{n}]", a, b, IPA_TOL)
                              for n, a, b in zip(("o", "optl", "norm", "opair"), got, want))

    for L in (64, 40, 256):
        args, tag, err = ipa2_check(64, L, "sampler", 500 + L)
        if L == 64:
            rows["ipa2"] = _time_row(tag, lambda: cuda_ipa.fused_ipa2(*args),
                                     lambda: cuda_ipa.ipa2_plain(*args), ipa2_bound_ms(64, L), err)
    for B, L in ((1, 1), (3, 37), (2, 100), (64, 128)):
        for layout in ("sampler", "train"):
            ipa2_check(B, L, layout, 550 + B * 1000 + L)
    args, tag, err = ipa2_check(32, 64, "train", 632)
    train_row = _time_row(tag, lambda: cuda_ipa.fused_ipa2(*args),
                          lambda: cuda_ipa.ipa2_plain(*args), ipa2_bound_ms(32, 64), err)
    say("kernels", f"ipa2 (K7) per launch: sampler layout B=64 L=64 {1e3 * rows['ipa2']['ms']:.1f} "
                   f"us, training layout B=32 L=64 {1e3 * train_row['ms']:.1f} us")
    # K8: its backward, in the training step's layouts: B=32 at L = 64 and 24
    # (the tile and pair kernels) and 128, 160 and 256 (the query, key and
    # pair kernels), and (B, L) = (3, 37), (1, 1) (two kernels), (2, 100) and
    # (3, 65) (three kernels, ragged last tiles).
    names = ("gq", "gkv", "gqp", "gkvp", "gr9", "gt", "gbias", "gpz", "gsw")
    per_call = native.function("ipa2_bwd", "ipa2_bwd_kernels_per_call", [ctypes.c_int])
    k8_us = {}
    for B, L in ((32, 64), (32, 24), (32, 128), (32, 160), (32, 256), (3, 37), (1, 1), (2, 100),
                 (3, 65)):
        seed = 700 + L if B == 32 else 700 + 1000 * B + L
        args = _ipa_inputs(B, L, dev, seed=seed, layout="train")
        cots = [_randn(tuple(o.shape), dev, seed + 100 + k)
                for k, o in enumerate(cuda_ipa.ipa2_plain(*args))]
        tag = f"ipa2_bwd B={B} L={L}"
        call = lambda: cuda_ipa.ipa2_bwd(*args, *cots)
        plain = lambda: cuda_ipa.ipa2_bwd_plain(*args, *cots)
        got = _launch_once("ipa2_bwd", call, tag)
        err = compare_grads(tag, names, got, plain(), call())
        check(per_call(L) == (2 if L <= 64 else 3), f"{tag}: {per_call(L)} kernels a call")
        say("kernels", f"{tag}: {per_call(L)} kernel launches a call")
        if B == 32:
            row = _time_row(tag, call, plain, ipa2_bwd_bound_ms(B, L), err)
            k8_us[L] = 1e3 * row["ms"]
            if L == 64:
                rows["ipa2_bwd"] = row
            elif L == 128:
                rows["ipa2_bwd_long"] = row
    say("kernels", "ipa2_bwd (K8) per call, training layout B=32: "
                   + ", ".join(f"L={L} {us:.1f} us" for L, us in k8_us.items()))

    # K6: the int8 EdgeTransition, readout off and on, flagship and ragged L.
    for L in (64, 40):
        edge, nb, mask, p, ro = _edge_inputs(64, L, dev, seed=900 + L)
        ops = cuda_edge.kernel_operands(p, ro, quant_int8=True)
        for with_ro in (False, True):
            r = ro if with_ro else None
            tag = f"edge_transition_int8{'+readout' if with_ro else ''} B=64 L={L}"
            call = lambda: cuda_edge.fused_edge_transition_int8(edge, nb, mask, p, readout=r,
                                                                ops=ops)
            plain = lambda: cuda_edge.edge_transition_int8_plain(edge, nb, mask, p,
                                                                 torch.bfloat16, r)
            got = _launch_once("edge_transition_int8", call, tag)
            got, want = (got, plain()) if with_ro else ((got,), (plain(),))
            err = max(compare(f"{tag} [{n}]", a, b, EDGE_TOL)
                      for n, a, b in zip(("out", "b", "pz"), got, want))
            if L == 64:
                row = _time_row(tag, call, plain,
                                edge_int8_bound_ms(64, L, n_ro=24 if with_ro else 0), err)
                if with_ro:
                    rows["edge_transition_int8"] = row

    # K9: the v1 IPA attention core through both wrappers; no model path uses
    # it. bf16 at the model's widths runs the tensor-core kernel (B=64 at L =
    # 64, 24, 100, 128, 256; B=2 at L=1), fp32 at the JAX tests' widths the
    # fp32 kernel (B=64 at L = 40, 256). Each call launches its one kernel
    # once (the library's count of each kernel); times on the device, the calls
    # queued behind a sleep (kernel_times.device_ms: the wrapper's host work
    # would set the per-call time at L=64).
    checks = 0
    k9_us = {}
    for widths, dt, B, L in (("model", torch.bfloat16, 64, 64), ("model", torch.bfloat16, 64, 24),
                             ("model", torch.bfloat16, 64, 100), ("model", torch.bfloat16, 64, 128),
                             ("model", torch.bfloat16, 64, 256), ("model", torch.bfloat16, 2, 1),
                             ("test", torch.float32, 64, 40), ("test", torch.float32, 64, 256)):
        args = _ipa1_inputs(B, L, widths, dt, dev, seed=1000 + L)
        tol = IPA_TOL if dt == torch.bfloat16 else IPA1_FP32_TOL
        kernel = "ipa1_hopper_kernel" if widths == "model" else "ipa1_fwd_kernel"
        want_ran = (1, 0) if widths == "model" else (0, 1)
        want = cuda_ipa1.ipa_attention_plain(*args)
        for fn in (cuda_ipa1.fused_ipa_attention, cuda_ipa1.fused_ipa_attention_bh):
            tag = f"ipa1 {fn.__name__} B={B} L={L} {widths} widths {str(dt)[6:]}"
            got = _launch_once("ipa1", lambda: fn(*args), tag)
            checks += 1
            err = max(compare(f"{tag} [{n}]", a, b, tol)
                      for n, a, b in zip(("o", "o_pt", "o_pair"), got, want))
            ran = _ipa1_kernels(lambda: fn(*args))
            checks += 1
            check(ran == want_ran, f"{tag}: launched {ran} (tensor-core, fp32) kernels, "
                                   f"not one {kernel}")
        say("kernels", f"ipa1 B={B} L={L} {widths} widths: one {kernel} launch a call")
        if widths == "model" and B == 64 and L in (64, 128, 256):
            row = _time_row(f"ipa1 B=64 L={L} model widths bf16",
                            lambda: cuda_ipa1.fused_ipa_attention(*args),
                            lambda: cuda_ipa1.ipa_attention_plain(*args),
                            ipa_v1_bound_ms(64, L), err, timer=device_ms)
            k9_us[L] = 1e3 * row["ms"]
            if L == 64:
                rows["ipa1"] = row
        elif widths == "test":
            _time_row(f"ipa1 B=64 L={L} test widths fp32",
                      lambda: cuda_ipa1.fused_ipa_attention(*args),
                      lambda: cuda_ipa1.ipa_attention_plain(*args),
                      ipa_v1_bound_ms(64, L, H=4, C=32, Pq=4, Pv=6, cz4=8, in_bytes=4), err,
                      timer=device_ms)
    say("kernels", "ipa1 (K9) device time a call, model widths bf16, B=64: "
                   + ", ".join(f"L={L} {us:.1f} us ({1e5 * ipa_v1_bound_ms(64, L)[0] / us:.1f}% "
                               f"of its bound)" for L, us in k9_us.items()))
    rows["ipa1"]["checks"] = checks
    return rows


def _dist_inputs(B, L, dev, seed, one_token=False):
    """Inputs of the distance block: atoms within ~1.5 nm, ~15% of the atoms
    and ~20% of the residues masked, random tokens (all 5 with
    `one_token`), the model's weight scales."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    f = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(dev)
    aa = np.full((B, L), 5) if one_token else rng.integers(0, 22, size=(B, L))
    args = (f(rng.normal(size=(B, L, 15, 3)) * 0.5), f(rng.random((B, L, 15)) > 0.15),
            torch.from_numpy(aa).to(dev), f(rng.random((B, L)) > 0.2))
    p = {"table": f(rng.normal(size=(484, 225))), "k1": f(rng.normal(size=(225, 64)) * 0.07),
         "b1": f(rng.normal(size=64) * 0.1), "k2": f(rng.normal(size=(64, 64)) * 0.12),
         "b2": f(rng.normal(size=64) * 0.1)}
    return args, p


def _ipa1_inputs(B, L, widths, dtype, dev, seed):
    """Inputs of the v1 attention core, head-major, at the model's widths
    (H 8, C 128, Pq 8, Pv 12, CZ4 16) or the JAX tests' (H 4, C 32, Pq 4,
    Pv 6, CZ4 8): q, k, v, bias and pair_z in `dtype`, global points fp32,
    about 15% of the keys masked."""
    import torch

    H, C, Pq, Pv, CZ4 = (8, 128, 8, 12, 16) if widths == "model" else (4, 32, 4, 6, 8)
    r = lambda *s, k: _randn(s, dev, seed + k)
    mask = (torch.rand(B, L, generator=torch.Generator().manual_seed(seed)) > 0.15).float().to(dev)
    return [r(B, H, L, C, k=1).to(dtype), r(B, H, L, C, k=2).to(dtype), r(B, H, L, C, k=3).to(dtype),
            r(B, H, L, 3 * Pq, k=4), r(B, H, L, 3 * Pq, k=5), r(B, H, L, 3 * Pv, k=6),
            r(B, H, L, L, k=7).to(dtype), r(B, L, L, CZ4, k=8).to(dtype), mask]


def _ipa_inputs(B, L, dev, seed, layout):
    """Inputs of the fused IPA at the production widths (H 8, C 128, Pq 8,
    Pv 12, CZ4 16) as the module passes them: the points as permuted views
    of the projections; with layout "sampler" the pair bias (B, H, L, L) and
    the pair readout as a view of the EdgeTransition epilogue's
    (B, CZ4, L, L), with "train" the bias as a view of linear_b's
    (B, L, L, H) and the readout down_z's (B, L, L, CZ4). bf16 where the
    model feeds bf16; random rotations, translations of ~5 A."""
    import torch

    H, C, Pq, Pv, CZ4 = 8, 128, 8, 12, 16
    bf = torch.bfloat16
    r = lambda *s, sc=1.0, k=0: _randn(s, dev, seed + k) * sc
    R = torch.linalg.qr(_randn((B, L, 3, 3), dev, seed + 1))[0]
    mask = (torch.rand(B, L, generator=torch.Generator().manual_seed(seed)) > 0.15).float().to(dev)
    qp = r(B, L, 3, H, Pq, sc=2.0, k=2).to(bf).permute(0, 3, 2, 1, 4)
    kvp = r(B, L, 3, H, Pq + Pv, sc=2.0, k=3).to(bf).permute(0, 3, 2, 1, 4)
    if layout == "sampler":
        bias, pz = r(B, H, L, L, k=4).to(bf), r(B, CZ4, L, L, k=5).to(bf).permute(0, 2, 3, 1)
    else:
        bias, pz = r(B, L, L, H, k=4).to(bf).permute(0, 3, 1, 2), r(B, L, L, CZ4, k=5).to(bf)
    sw = r(1, H, sc=0.1, k=6).abs() + 0.2
    return [r(B, L, H * C, k=7).to(bf), r(B, L, 2 * H * C, k=8).to(bf), qp, kvp,
            R.reshape(B, L, 9).contiguous(), r(B, L, 3, sc=5.0, k=9), bias, pz,
            (1e5 * (mask - 1.0))[:, None, :], sw]


def _randn(shape, dev, seed):
    import torch

    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed)).to(dev)


def _launch_once(name, call, tag):
    """One call of a kernel wrapper, synchronized, that must count one launch."""
    import torch

    from pepflowww_torch import native

    before = native.LAUNCHES[name]
    out = call()
    torch.cuda.synchronize()
    check(native.LAUNCHES[name] == before + 1, f"{tag}: no launch counted")
    return out


def _ipa1_kernels(call) -> tuple:
    """(tensor-core, fp32) launches of csrc/ipa1.cu's two kernels in one
    synchronized call of `call`, by the library's own count of the launches
    the runtime accepted. torch.profiler's CUPTI trace is not used here: on
    an H100 machine it has returned no device activity, three profiles in a
    row, for calls whose kernel ran."""
    import ctypes

    import torch

    from pepflowww_torch import native

    count = native.function("ipa1", "ipa1_kernel_launches", [ctypes.c_int])
    torch.cuda.synchronize()
    before = count(0), count(1)
    call()
    torch.cuda.synchronize()
    return count(0) - before[0], count(1) - before[1]


def compare_grads(tag, names, got, want, again, phase: str = "kernels") -> float:
    """Each gradient within BWD_REL of the plain gradient's norm and
    bit-identical across two calls; returns the largest max abs error."""
    import torch

    worst = 0.0
    for name, a, b, c in zip(names, got, want, again):
        a, b = a.float(), b.float()
        check(bool(torch.isfinite(a).all()), f"{tag} [{name}]: non-finite kernel output")
        check(torch.equal(a, c.float()), f"{tag} [{name}]: two calls differ")
        rel = float((a - b).norm() / b.norm().clamp_min(1e-30))
        max_abs = float((a - b).abs().max())
        worst = max(worst, max_abs)
        say(phase, f"{tag} [{name}]: max_abs_err={max_abs:.3e} (|plain| max "
                       f"{float(b.abs().max()):.3e}), ||diff||/||plain|| {rel:.3e} "
                       f"(tolerance {BWD_REL}), bit-identical across two calls")
        check(rel <= BWD_REL, f"{tag} [{name}]: kernel disagrees with its plain version")
    return worst


def _time_row(tag, call, plain, bound, err, timer=None) -> dict:
    """The kernel's, the plain version's and the bound's times (`timer`:
    cuda_ms unless given)."""
    timer = timer or cuda_ms
    k_ms = timer(call)
    p_ms = timer(plain, reps=3, warmup=1)
    bound_ms, by = bound
    say("kernels", f"{tag}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound "
                   f"{bound_ms:.4f} ms by {by} ({100 * bound_ms / k_ms:.1f}% of bound)")
    return dict(err=err, ms=k_ms, plain_ms=p_ms, bound_ms=bound_ms, bound_by=by)


def _oracle_stats(out, gen):
    """Per-sample AAR and RMS translation norm over the generated rows."""
    n = gen.sum(-1)
    aar = ((out["seqs"] == out["seqs_1"]) & gen).sum(-1).double() / n
    tn = ((out["trans"].double().square().sum(-1) * gen).sum(-1) / n).sqrt()
    return aar.cpu().numpy(), tn.cpu().numpy()


def phase_oracle(phase: str = "oracle", ipa: bool = False, int8: bool = False,
                 golden: str = "sampler_stats_trained6", seeds=(53, 54, 55)):
    """The bf16 kernel sampler with the weights of a trained reference oracle
    against its AAR and translation norm: fused IPA with `ipa`, the int8
    EdgeTransitions with `int8`."""
    import numpy as np
    import torch

    from pepflowww_torch import native
    from pepflowww_torch.models.flow import FlowModelConfig, build_model
    from pepflowww_torch.models.trunk import IPAConfig
    from pepflowww_torch.sampling import euler_sample

    dev = torch.device("cuda", 0)
    g = np.load(os.path.join(ROOT, "tests", "golden", f"{golden}.npz"))
    nb, steps, n = int(g["num_blocks"]), int(g["num_steps"]), int(g["num_samples"])
    sd = {k[4:]: np.asarray(g[k], np.float32) for k in g.files if k.startswith("sd::")}
    cfg = FlowModelConfig(ipa=IPAConfig(num_blocks=nb, dtype="bfloat16", use_pallas=True,
                                        use_pallas_ipa=ipa, quant_int8=int8))
    model = build_model(cfg, dev, state_dict=sd)
    batch = {k[6:]: torch.from_numpy(np.asarray(g[k])).to(dev) for k in g.files
             if k.startswith("batch_")}
    gen = batch["generate_mask"].bool()
    edge_kernel = "edge_transition_int8" if int8 else "edge_transition"
    want = {**dict.fromkeys(native.SOURCES, 0), edge_kernel: (nb - 1) * steps,
            "distance_embed": 1, "ipa2": nb * steps if ipa else 0}
    aars, tns = [], []
    for seed in seeds:
        native.reset_launch_counts()
        out = euler_sample(model, batch, torch.Generator(device=dev).manual_seed(seed),
                           num_steps=steps)
        torch.cuda.synchronize()
        counts = dict(native.LAUNCHES)
        check(counts == want, f"{phase} seed {seed}: launched {counts}, expected {want}")
        aar, tn = _oracle_stats(out, gen)
        aars.append(aar)
        tns.append(tn)
        say(phase, f"seed {seed}: aar {aar.mean():.4f}, trans_norm {tn.mean():.4f}, "
                   f"launches {counts}")
    for name, ours in (("aar", np.concatenate(aars)), ("trans_norm", np.concatenate(tns))):
        ref = g[name]
        sem = np.sqrt(np.var(ref) / n + np.var(ours) / len(ours))
        tol = 2.0 * float(sem) + max(0.05 * float(np.std(ref)), 3e-3)
        diff = abs(float(np.mean(ours)) - float(np.mean(ref)))
        say(phase, f"{name}: ours {np.mean(ours):.4f} vs trained nb={nb} reference "
                   f"{np.mean(ref):.4f}, |diff| {diff:.4f} <= tol {tol:.4f}")
        check(diff <= tol, f"{phase} {name} outside the 2-sigma bound")


def phase_main(card: str, cfg, phase: str, want: dict):
    """The sampler of `cfg` on the main path's workload; checks the launch
    counts against `want` and writes a few PDBs."""
    import numpy as np
    import torch

    from pepflowww_torch import native
    from pepflowww_torch.inference import write_sample_pdbs
    from pepflowww_torch.profile_sampler import main_path_batch, production_model
    from pepflowww_torch.sampling import euler_sample

    dev = torch.device("cuda", 0)
    B, steps = 64, 100
    model = production_model(dev, cfg)
    batch, bnp = main_path_batch(dev, B)
    euler_sample(model, batch, torch.Generator(device=dev).manual_seed(0), num_steps=2)  # warm-up

    native.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = euler_sample(model, batch, torch.Generator(device=dev).manual_seed(1), num_steps=steps)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = dict(native.LAUNCHES)
    say(phase, f"B={B} L=64 steps={steps} kernels on: {sec:.3f} s, "
               f"{B / sec:.3f} peptides/s on {card}; launches {launches}")
    check(launches == want, f"{phase}: launched {launches}, expected {want}")
    for k in ("rotmats", "trans", "angles"):
        check(bool(torch.isfinite(out[k]).all()), f"{phase}: non-finite {k}")
    check(tuple(out["trans"].shape) == (B, 64, 3) and tuple(out["rotmats"].shape) == (B, 64, 3, 3),
          f"{phase}: unexpected output shapes")
    seqs = out["seqs"][batch["generate_mask"].bool()]
    check(bool(((seqs >= 0) & (seqs < 20)).all()), f"{phase}: generated tokens out of range")

    few = {k: v[:4] for k, v in out.items()}
    few_np = {k: (v[:4] if isinstance(v, np.ndarray) else v) for k, v in bnp.items()}
    paths = write_sample_pdbs(few, few_np,
                              os.path.join(OUT_DIR, f"smoke_pdbs_{phase.replace(' ', '_')}"))
    for path in paths:
        atoms = [ln for ln in open(path).read().splitlines() if ln.startswith("ATOM")]
        xyz = np.array([[float(ln[30:38]), float(ln[38:46]), float(ln[46:54])] for ln in atoms])
        ca = xyz[[i for i, ln in enumerate(atoms) if ln[12:16] == " CA "]]
        check(len(atoms) > 4 * 60 and np.isfinite(xyz).all(), f"{path}: malformed ATOM records")
        check(len(ca) == 60 and {ln[21] for ln in atoms} == {"A", "B"}, f"{path}: wrong residues")
    say(phase, f"wrote {len(paths)} PDBs with well-formed ATOM records to "
               f"{os.path.dirname(paths[0])}")
    return launches, B / sec


class plain_versions:
    """Within the block, the EdgeTransition, distance and fused-IPA
    Functions run their plain PyTorch versions on the card (forward and
    backward, the kernels' rounding points): the reference that the kernel
    step is held to."""

    def __enter__(self):
        from pepflowww_torch.models import cuda_dist, cuda_edge, cuda_ipa

        self.saved = [(cuda_edge, "_forward", cuda_edge._forward),
                      (cuda_edge, "edge_transition_bwd", cuda_edge.edge_transition_bwd),
                      (cuda_dist, "_forward", cuda_dist._forward),
                      (cuda_dist, "distance_embed_bwd", cuda_dist.distance_embed_bwd),
                      (cuda_ipa, "_forward", cuda_ipa._forward),
                      (cuda_ipa, "ipa2_bwd", cuda_ipa.ipa2_bwd)]
        cuda_ipa._forward = cuda_ipa.ipa2_plain
        cuda_ipa.ipa2_bwd = cuda_ipa.ipa2_bwd_plain
        cuda_edge._forward = lambda e, n, m, p, dt, ro=None, ops=None, eps=1e-5: \
            cuda_edge.edge_transition_plain(e, n, m, p, dt, ro, eps)
        cuda_edge.edge_transition_bwd = lambda e, n, m, p, g, dt, ops=None, d_edge_dtype=None: \
            tuple(x.to(d_edge_dtype) if i == 0 else x for i, x in
                  enumerate(cuda_edge.edge_transition_bwd_plain(e, n, m, p, g, dt)))
        cuda_dist._forward = lambda pos, am, aa, sm, p, dt, ops=None: \
            cuda_dist.distance_embed_plain(pos, am, aa, sm, p, dt)
        cuda_dist.distance_embed_bwd = lambda pos, am, aa, sm, p, g, dt, ops=None: \
            cuda_dist.distance_embed_bwd_plain(pos, am, aa, sm, p, g, dt)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def phase_train(card: str, cfg, phase: str, want: dict, complex_=(12, 48, 64), descent=True,
                timed_steps=20, batch=None):
    """The training step of `cfg` at B=32 on synthetic complexes of
    `complex_` = (peptide, pocket, padded length), or on the device batch
    `batch` where given: launches per step, a finite gradient for every
    parameter, the gradients against the same step through the plain
    versions, with `descent` 30 Adam steps that must lower the loss, and
    ms/step over `timed_steps` steps."""
    import numpy as np
    import torch

    from pepflowww_torch import native
    from pepflowww_torch.config import load_train_config
    from pepflowww_torch.models.flow import draw_noise
    from pepflowww_torch.profile_sampler import main_path_batch, production_model
    from pepflowww_torch.training.optim import Optimizer
    from pepflowww_torch.training.train_step import loss_and_total, train_step

    dev = torch.device("cuda", 0)
    _, raw, _ = load_train_config(os.path.join(ROOT, "configs", "learn_angle_tpu.yaml"))
    tc = raw["train"]
    B, weights = int(tc["batch_size"]), dict(tc["loss_weights"])
    model = production_model(dev, cfg).train()
    if batch is None:
        batch, _ = main_path_batch(dev, B, seed=7, complex_=complex_)
    B, L = batch["aa"].shape
    noise = draw_noise(B, L, torch.Generator(device=dev).manual_seed(8), dev)

    def grads_of_one_backward():
        model.zero_grad(set_to_none=True)
        total, _ = loss_and_total(model, batch, weights, noise=noise)
        total.backward()
        return {n: p.grad for n, p in model.named_parameters()}

    grads_of_one_backward()   # warm-up: kernel operands, allocator
    torch.cuda.synchronize()
    native.reset_launch_counts()
    got = grads_of_one_backward()
    torch.cuda.synchronize()
    launches = dict(native.LAUNCHES)
    say(phase, f"B={B} L={L} bf16 kernels on: launches per step {launches}")
    check(launches == want, f"{phase} step launched {launches}, expected {want}")
    missing = [n for n, g in got.items() if g is None or not bool(torch.isfinite(g).all())]
    check(not missing, f"{phase} step: parameters without a finite gradient: {missing}")
    say(phase, f"all {len(got)} parameters have a finite gradient after one backward")

    got = {n: g.clone() for n, g in got.items()}
    with plain_versions():
        want_g = grads_of_one_backward()
    G = float(torch.stack([g.norm() for g in want_g.values()]).norm())
    worst_name, worst = "", 0.0
    for n, g in got.items():
        err, ref = float((g - want_g[n]).norm()), float(want_g[n].norm())
        excess = err / (STEP_REL * ref + STEP_ABS * G)
        if excess > worst:
            worst_name, worst = n, excess
        check(excess <= 1.0, f"{phase} step: {n} kernel gradient off the plain one: "
                             f"||dg|| {err:.3e}, ||g|| {ref:.3e}, global {G:.3e}")
    rel_all = float(torch.stack([(got[n] - want_g[n]).norm() for n in got]).norm()) / G
    say(phase, f"kernel step vs plain step gradients: global ||dg||/||g|| {rel_all:.3e}; every "
                 f"parameter within {STEP_REL} ||g|| + {STEP_ABS} x global ({G:.3e}); closest "
                 f"to its limit {worst_name} at {worst:.3f} of it")

    optimizer = Optimizer(model.parameters(), tc["optimizer"], tc["max_grad_norm"])
    if descent:
        losses = [float(train_step(model, optimizer, batch, weights, noise=noise)["loss"])
                  for _ in range(30)]
        say(phase, f"30 Adam steps on one batch and one draw: loss {losses[0]:.4f} -> "
                   f"{losses[-1]:.4f}")
        check(np.isfinite(losses).all() and losses[-1] < losses[0],
              f"{phase}: loss did not decrease")

    gen = torch.Generator(device=dev).manual_seed(9)
    for _ in range(3):
        train_step(model, optimizer, batch, weights, gen)
    steps = timed_steps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        m = train_step(model, optimizer, batch, weights, gen)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / steps
    check(np.isfinite(float(m["loss"])), f"{phase}: non-finite loss in the timed steps")
    say(phase, f"B={B} L={L} bf16 kernels on: {ms:.3f} ms/step, {1e3 * B / ms:.3f} samples/s "
               f"over {steps} steps on {card}")
    return launches, ms


def phase_train_int8(cfg):
    """A training step of the int8 serving profile must raise its
    forward-only error and launch no EdgeTransition kernel: no silent bf16
    step."""
    import torch

    from pepflowww_torch import native
    from pepflowww_torch.config import DEFAULT_TRAIN
    from pepflowww_torch.profile_sampler import main_path_batch, production_model
    from pepflowww_torch.training.optim import Optimizer
    from pepflowww_torch.training.train_step import train_step

    dev = torch.device("cuda", 0)
    tc = DEFAULT_TRAIN
    model = production_model(dev, cfg).train()
    optimizer = Optimizer(model.parameters(), tc["optimizer"], tc["max_grad_norm"])
    batch, _ = main_path_batch(dev, int(tc["batch_size"]), seed=7)
    native.reset_launch_counts()
    try:
        train_step(model, optimizer, batch, tc["loss_weights"], torch.Generator(device=dev))
        error = None
    except RuntimeError as e:
        error = str(e)
    torch.cuda.synchronize()
    launches = {k: v for k, v in native.LAUNCHES.items() if v}
    check(error is not None and "quant_int8" in error,
          f"train int8: the step did not raise the forward-only error ({error!r})")
    check(not any(native.LAUNCHES[k] for k in ("edge_transition", "edge_transition_int8",
                                               "edge_transition_bwd")),
          f"train int8: an EdgeTransition kernel ran before the refusal: {launches}")
    say("train int8", f"a training step raised, as it must: {error}; launches before it "
                      f"{launches}")


def _strip_side_chains(path: str, n: int = 3) -> list:
    """Delete the side-chain ATOM lines (all but N, CA, C, O) of the first
    `n` residues of `path` that have at least two; returns their resseq."""
    lines = open(path).read().splitlines()
    side = {}
    for ln in lines:
        if ln.startswith("ATOM") and ln[12:16].strip() not in ("N", "CA", "C", "O"):
            side[int(ln[22:26])] = side.get(int(ln[22:26]), 0) + 1
    cut = [r for r in sorted(side) if side[r] >= 2][:n]
    keep = [ln for ln in lines if not (ln.startswith("ATOM") and int(ln[22:26]) in cut
                                       and ln[12:16].strip() not in ("N", "CA", "C", "O"))]
    with open(path, "w") as f:
        f.write("\n".join(keep) + "\n")
    return cut


def phase_data(card: str, prod):
    """The host data path into the sample CLI on the card (phase 6)."""
    import csv
    import shutil

    import numpy as np
    import torch

    from pepflowww_torch import bench, native, sample
    from pepflowww_torch import constants as C
    from pepflowww_torch.data.collate import device_batch, pad_and_collate, replicate_item
    from pepflowww_torch.data.dataset import PepDataset
    from pepflowww_torch.data.synthetic import write_structure_dir
    from pepflowww_torch.metrics import summarize_outputs
    from pepflowww_torch.profile_sampler import production_model

    dev = torch.device("cuda", 0)
    structs, cache, out_dir = (os.path.join(OUT_DIR, d) for d in ("structs", "cache", "samples"))
    for d in (structs, cache, out_dir):
        shutil.rmtree(d, ignore_errors=True)
    ids = write_structure_dir(structs, sizes=DATA_SIZES, seed=11)
    cut = _strip_side_chains(os.path.join(structs, ids[-1], "pocket.pdb"))
    check(len(cut) == 3, f"data: found {cut} pocket residues with side chains to cut")
    t0 = time.perf_counter()
    ds = PepDataset(structs, cache, name="smoke")
    items = [ds[i] for i in range(len(ds))]
    lengths = [len(it["aa"]) for it in items]
    buckets = [int(pad_and_collate([it])["aa"].shape[1]) for it in items]
    say("data", f"preprocessed {len(ds)} complexes ({time.perf_counter() - t0:.1f} s, spawned "
                f"pool) into {cache}: residues {lengths}, buckets {buckets}")
    check(ds.ids == ids and buckets == [32, 48, 64, 96, 128, 160],
          f"data: ids {ds.ids} or buckets {buckets} are not the written ones")
    big = items[-1]
    partial = int((big["mask_heavyatom"].sum(-1) < C.HEAVYATOM_MASK_GEN[big["aa"]].sum(-1)).sum())
    check(partial == 3, f"data: {partial} residues of {ids[-1]} with a partial atom mask, "
                        f"expected 3")
    say("data", f"{ids[-1]}: pocket residues {cut} without side chains, {partial} partial "
                f"rows of mask_heavyatom")

    # Model level: the L=160 item at B=16, the kernels against their plain
    # versions on the same path.
    bnp = pad_and_collate(replicate_item(big, 16))
    batch = device_batch(bnp, dev)
    # Printed beside the gate, not gates: kernels on against off (the gate's
    # gap plus the fused readout's against the plain path's rounding), and
    # the same weights in float32 without kernels (the scale of bf16's).
    fp32 = dataclasses.replace(prod, ipa=dataclasses.replace(prod.ipa, dtype=None))
    outs = {}
    for tag, cfg, on in (("on", prod, True), ("on, plain versions", prod, True),
                         ("off", prod, False), ("fp32", fp32, False)):
        model = production_model(dev, cfg, on)
        native.reset_launch_counts()
        with torch.no_grad(), (plain_versions() if "plain" in tag else contextlib.nullcontext()):
            enc = model.encode(batch)
            den = model.denoise(torch.full((16, 1), 0.5, device=dev), *enc,
                                batch["generate_mask"], batch["res_mask"],
                                fused_pair_readout=on)
        torch.cuda.synchronize()
        launched = {k: v for k, v in native.LAUNCHES.items() if v}
        want = {"edge_transition": prod.ipa.num_blocks - 1, "distance_embed": 1} \
            if tag == "on" else {}
        check(launched == want, f"data: model check ({tag}) launched {launched}, expected {want}")
        outs[tag] = [x.float() for x in (enc[4], enc[5]) + tuple(den)]

    def gaps(a_tag, b_tag):
        out = {}
        for name, a, b in zip(("node", "edge", "rot", "trans", "angles", "logits"), outs[a_tag],
                              outs[b_tag]):
            check(bool(torch.isfinite(a).all()), f"data: non-finite {name} ({a_tag})")
            d = a - b
            out[name] = float((torch.atan2(torch.sin(d), torch.cos(d)) if name == "angles"
                               else d).abs().max())
        return out

    errs = gaps("on", "on, plain versions")
    say("data", "L=160 B=16 encode + denoise at t=0.5, the kernels vs their plain versions on "
                "the same path, max abs error: "
                + ", ".join(f"{k} {v:.3e} (tol {DATA_TOL[k]})" for k, v in errs.items()))
    for a_tag, b_tag, what in (("on", "off", "kernels on vs off"),
                               ("off", "fp32", "bf16 without kernels vs float32")):
        say("data", f"L=160 B=16, {what}: "
                    + ", ".join(f"{k} {v:.3e}" for k, v in gaps(a_tag, b_tag).items()))
    for name, err in errs.items():
        check(err <= DATA_TOL[name], f"data: {name} with the kernels off their plain versions "
                                     f"by {err:.3e} > {DATA_TOL[name]}")

    # The sample CLI on the card.
    argv = ["--config", os.path.join(ROOT, "configs", "learn_angle_tpu.yaml"),
            "--structure_dir", structs, "--dataset_dir", cache, "--dataset_name", "smoke",
            "--out", out_dir, "--num_samples", "32", "--num_steps", "100", "--device", "cuda"]
    native.reset_launch_counts()
    t0 = time.perf_counter()
    res = sample.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(native.LAUNCHES)
    want = {**dict.fromkeys(native.SOURCES, 0), "edge_transition": 500 * len(ids),
            "distance_embed": len(ids)}
    say("data", f"sample CLI: {len(ids)} complexes x 32 samples x 100 steps in {wall:.1f} s; "
                f"launches {launches}")
    check(launches == want, f"data: the sample CLI launched {launches}, expected {want}")
    with open(os.path.join(out_dir, "outputs.csv"), newline="") as f:
        reader = csv.DictReader(f)
        rows, header = list(reader), reader.fieldnames
    check(header == list(sample.CSV_COLUMNS) and len(rows) == 32 * len(ids)
          and all(np.isfinite(float(r[k])) for r in rows for k in header[2:]),
          f"data: outputs.csv has header {header} and {len(rows)} rows, or a non-finite metric")
    summary = json.load(open(os.path.join(out_dir, "summary.json")))
    check(set(summary["overall"]) == SUMMARY_KEYS == set(summarize_outputs(rows)["overall"]),
          f"data: summary.json overall keys {sorted(summary['overall'])}")
    n_pdb = 0
    for cid, n_res in zip(ids, lengths):
        for k in range(32):
            atoms = [ln for ln in open(os.path.join(out_dir, cid, f"sample_{k}.pdb"))
                     if ln.startswith("ATOM")]
            xyz = np.array([[float(ln[30:38]), float(ln[38:46]), float(ln[46:54])]
                            for ln in atoms])
            ca = sum(1 for ln in atoms if ln[12:16] == " CA ")
            check(len(atoms) > 4 * n_res and np.isfinite(xyz).all() and ca == n_res
                  and {ln[21] for ln in atoms} == {"A", "B"},
                  f"data: {cid}/sample_{k}.pdb: malformed ATOM records")
            n_pdb += 1
    say("data", f"outputs.csv: {len(rows)} rows, finite; summary.json overall "
                f"{json.dumps(summary['overall'], sort_keys=True)}; {n_pdb} PDBs with "
                f"well-formed ATOM records")
    for run in res["runs"]:
        say("data", f"{run['id']} L={run['L']} B=32 100 steps: {run['seconds']:.3f} s, "
                    f"{run['peptides_per_s']:.3f} peptides/s on {card}; metrics and 32 PDBs "
                    f"on the host {run['post_seconds']:.3f} s")

    # The bench's measurement at L64_B64, one timed run.
    line = bench.report(bench.bench_ours(reps=1, buckets=("L64_B64",)))
    keys = {"metric", "value", "unit", "vs_baseline", "baseline", "sampling_pps",
            "sampling_pps_plain", "train_samples_per_sec", "train_step_ms",
            "sampler_flops_per_batch", "mfu", "device"}
    check(set(line) == keys and set(line["sampling_pps"]) == set(bench.BUCKETS)
          and set(line["mfu"]) == {"train", "sample", "peak_tflops_assumed"}
          and set(line["device"]) == {"name", "power_limit"} and line["value"] > 0
          and line["sampling_pps_plain"] > 0 and line["train_step_ms"] > 0,
          f"data: the bench line lacks a key or a value: {line}")
    say("data", f"bench (L64_B64 only, one timed run): {json.dumps(line)}")


def _bucket_sizes(seed: int, spec) -> list:
    """(peptide, pocket) lengths: for each (bucket, n) of `spec`, n complexes
    of 3-25-residue peptides whose total length lies above the bucket below
    and at most `bucket`."""
    import numpy as np

    from pepflowww_torch.data.collate import DEFAULT_BUCKETS

    rng = np.random.default_rng(seed)
    sizes = []
    for bucket, n in spec:
        below = max([b for b in DEFAULT_BUCKETS if b < bucket], default=0)
        for _ in range(n):
            total, pep = int(rng.integers(below + 1, bucket + 1)), int(rng.integers(3, 26))
            sizes.append((pep, total - pep))
    return sizes


def _train_cli(tag: str, config: str, argv: list, want: dict) -> tuple:
    """`pepflowww_torch.train.main` in-process on the card; checks its
    launches against `want` and its losses; returns (run directory, log
    text, validation records)."""
    import numpy as np
    import torch

    from pepflowww_torch import native, train

    native.reset_launch_counts()
    t0 = time.perf_counter()
    run = train.main(["--config", config, *argv])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(native.LAUNCHES)
    log = open(os.path.join(run, "log.txt")).read()
    recs = [json.loads(line) for line in open(os.path.join(run, "metrics.jsonl"))]
    train_recs = [r for r in recs if r["tag"] == "train"]
    vals = [r for r in recs if r["tag"] == "val"]
    check(bool(train_recs) and all(np.isfinite(r[k]) for r in recs for k in r
                                   if k.endswith("loss")),
          f"{tag}: a non-finite loss in {run}/metrics.jsonl")
    say(tag, f"{run}: {len(vals)} validations, {wall:.1f} s; launches {launches}, expected "
             f"{want}")
    check(launches == want, f"{tag}: launched {launches}, expected {want}")
    check(os.path.isfile(os.path.join(run, "commit.txt")), f"{tag}: no commit.txt in {run}")
    say(tag, "losses " + ", ".join(f"it {r['step']} {r['loss']:.4f}" for r in train_recs)
             + "; " + ", ".join(f"val it {r['step']} {r['loss']:.4f}" for r in vals))
    return run, log, vals


def phase_train_data(card: str, prod, ipa, ipa_yaml: str):
    """The training data path on the card (phase 7)."""
    import math
    import shutil

    import numpy as np
    import torch

    from pepflowww_torch import constants as C
    from pepflowww_torch import native
    from pepflowww_torch.data.collate import device_batch, pad_and_collate
    from pepflowww_torch.data.dataset import DataLoader, PepDataset
    from pepflowww_torch.data.synthetic import write_structure_dir
    from pepflowww_torch.profile_sampler import production_model
    from pepflowww_torch.training.optim import Optimizer
    from pepflowww_torch.training.train_step import train_step

    phase = "train data"
    dev = torch.device("cuda", 0)
    structs, val_structs, cache, logs = (os.path.join(OUT_DIR, d) for d in (
        "train_structs", "val_structs", "train_cache", "train_logs"))
    for d in (structs, val_structs, cache, logs):
        shutil.rmtree(d, ignore_errors=True)
    ids = write_structure_dir(structs, sizes=_bucket_sizes(21, TRAIN_SPEC), seed=21)
    val_ids = write_structure_dir(val_structs, sizes=_bucket_sizes(22, VAL_SPEC), seed=22)
    n64 = TRAIN_SPEC[0][1]
    excluded, stripped = [ids[0], ids[n64]], ids[n64 + 1]
    names = os.path.join(OUT_DIR, "train_exclude.txt")
    with open(names, "w") as f:
        f.write("\n".join(excluded) + "\n")
    cut = _strip_side_chains(os.path.join(structs, stripped, "pocket.pdb"))
    check(len(cut) == 3, f"{phase}: found {cut} pocket residues with side chains to cut")
    t0 = time.perf_counter()
    ds = PepDataset(structs, cache, name="smoke_train", exclude_names_file=names)
    val = PepDataset(val_structs, cache, name="smoke_val")
    say(phase, f"preprocessed {len(ids)} training and {len(val_ids)} validation complexes "
               f"({time.perf_counter() - t0:.1f} s, spawned pool) into {cache}")
    check(ds.ids == [i for i in ids if i not in excluded] and val.ids == val_ids,
          f"{phase}: the cache holds {len(ds)} training ids; the excluded {excluded} must be "
          f"missing and every other id present")
    say(phase, f"excluded {excluded}: missing from the cache, {len(ds)} training complexes")

    B = int(prod_train_cfg()["batch_size"])
    loader = DataLoader(ds, batch_size=B, shuffle=True, seed=int(prod_train_cfg()["seed"]))
    plan = loader._batch_plan()
    val_plan = DataLoader(val, batch_size=B, shuffle=False, drop_last=False)._batch_plan()
    check(sorted(b for b, _ in plan) == [64, 128] and all(len(i) == B for _, i in plan),
          f"{phase}: training plan {[(b, len(i)) for b, i in plan]}, expected one batch of "
          f"{B} in each of the buckets 64 and 128")
    check([(b, len(i)) for b, i in val_plan] == [(48, 20), (160, 20)],
          f"{phase}: validation plan {[(b, len(i)) for b, i in val_plan]}")
    say(phase, f"training plan an epoch {[(b, len(i)) for b, i in plan]}; validation plan "
               f"{[(b, len(i)) for b, i in val_plan]} (ragged, drop_last off)")
    # The loader's own host time (record reads, decompression, padding):
    # the prefetch thread spends it beside each step.
    t0 = time.perf_counter()
    n_read = sum(1 for _ in DataLoader(ds, batch_size=B, shuffle=True, seed=1))
    say(phase, f"loader on the host: {n_read} batches of B={B} in "
               f"{1e3 * (time.perf_counter() - t0) / n_read:.3f} ms a batch (record reads, "
               f"decompression, padding), on the prefetch thread beside the step")

    zero = dict.fromkeys(native.SOURCES, 0)
    per_step = {"edge_transition": 5, "edge_transition_bwd": 5, "distance_embed": 1,
                "distance_embed_bwd": 1}
    per_fwd = {"edge_transition": 5, "distance_embed": 1}

    def want_of(step, fwd, steps, validations):
        """Launches of `steps` training steps and of `validations` passes
        over the validation plan."""
        return {k: steps * step.get(k, 0) + validations * len(val_plan) * fwd.get(k, 0)
                for k in zero}

    common = ["--structure_dir", structs, "--dataset_dir", cache, "--dataset_name", "smoke_train",
              "--val_dataset_name", "smoke_val", "--val_structure_dir", val_structs,
              "--exclude_names", names, "--val_freq", "6", "--log_freq", "2", "--logdir", logs,
              "--device", "cuda"]
    profiles = (("production", os.path.join(ROOT, "configs", "learn_angle_tpu.yaml"), per_step,
                 per_fwd),
                ("fused IPA", ipa_yaml, {**per_step, "ipa2": 6, "ipa2_bwd": 6},
                 {**per_fwd, "ipa2": 6}))
    for name, config, step, fwd in profiles:
        tag = f"{phase} {name}"
        trace = os.path.join(OUT_DIR, "train_trace") if name == "production" else None
        run, log, vals = _train_cli(
            tag, config, common + ["--max_iters", "12", "--tag", name.replace(" ", "_")]
            + (["--profile_dir", trace] if trace else []), want_of(step, fwd, 12, 2))
        check("val it 6 |" in log and "val it 12 |" in log and len(vals) == 2,
              f"{tag}: no 'val it 6' and 'val it 12' lines")
        ckpts = sorted(os.listdir(os.path.join(run, "checkpoints")))
        check(ckpts == ["12.pt", "6.pt"], f"{tag}: checkpoints {ckpts}, expected 6 and 12")
        if trace:
            events = json.load(open(os.path.join(trace, "trace.json")))["traceEvents"]
            kernels = sum(1 for e in events if e.get("cat") == "kernel")
            check(kernels > 0, f"{tag}: the --profile_dir trace holds no CUDA kernel")
            say(tag, f"--profile_dir: {trace}/trace.json, {len(events)} events, {kernels} "
                     f"device kernels (iterations 11-12)")
        _, log2, vals2 = _train_cli(
            f"{tag} resume", config, common + ["--max_iters", "14", "--tag", "resume", "--resume",
                                               os.path.join(run, "checkpoints")],
            want_of(step, fwd, 2, 0))
        check("at iteration 13" in log2 and "it 14 | loss" in log2 and not vals2,
              f"{tag} resume: did not continue at 13 to 14")
        say(tag, f"resumed from {run}/checkpoints/12.pt at iteration 13; checkpoints 6 and 12, "
                 f"commit.txt present")

    # One real 128-bucket batch, its padding rows and partial atom masks:
    # the kernel step's gradients against the plain step, in both profiles.
    items = {b: [ds[j] for j in i] for b, i in plan}
    big = pad_and_collate(items[128], pad_to=128)
    gen = big["generate_mask"]
    partial = int((big["mask_heavyatom"].sum(-1) < C.HEAVYATOM_MASK_GEN[big["aa"]].sum(-1))[
        big["res_mask"]].sum())
    pad_rows = int((~big["res_mask"]).sum())
    check(stripped in big["id"] and partial >= 3 and pad_rows > 0,
          f"{phase}: the 128 batch lacks {stripped}, its partial rows ({partial}) or padding "
          f"({pad_rows})")
    say(phase, f"real batch B={B} L=128: {pad_rows} padding rows of {big['res_mask'].size}, "
               f"{partial} residues with a partial atom mask, {int(gen.sum())} generated")
    real = device_batch(big, dev)
    phase_train(card, prod, f"{phase} grads", {**zero, **per_step}, descent=False,
                timed_steps=5, batch=real)
    phase_train(card, ipa, f"{phase} grads ipa", {**zero, **per_step, "ipa2": 6, "ipa2_bwd": 6},
                descent=False, timed_steps=5, batch=real)

    # Padding: the loader's bucketed batches, and the reference's unbucketed
    # batches of the same items padded to their longest item rounded up to
    # 8; steps in turns. The lengths are drawn evenly over each bucket's
    # span, so this prices bucketing on made-up traffic, not on PepMerge's.
    eight = lambda its: 8 * math.ceil(max(len(it["aa"]) for it in its) / 8)
    mixed = DataLoader(ds, batch_size=B, shuffle=True, seed=int(prod_train_cfg()["seed"]),
                       bucket_by_length=False)._batch_plan()
    rules = {"bucket": [pad_and_collate(items[b], pad_to=b) for b in sorted(items)],
             "unbucketed, longest to 8": [pad_and_collate(its, pad_to=eight(its)) for its in
                                          ([ds[j] for j in i] for _, i in mixed)]}
    rules = {k: [device_batch(b, dev) for b in v] for k, v in rules.items()}
    for prof_name, cfg, names_ in (("production", prod, list(rules)),
                                   ("fused IPA", ipa, ["bucket"])):
        model = production_model(dev, cfg).train()
        tc = prod_train_cfg()
        optimizer = Optimizer(model.parameters(), tc["optimizer"], tc["max_grad_norm"])
        weights = dict(tc["loss_weights"])
        g = torch.Generator(device=dev).manual_seed(3)
        peak = {}
        for rule in names_:
            for b in rules[rule]:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                train_step(model, optimizer, b, weights, g)    # warm-up, and the peak memory
                torch.cuda.synchronize()
                peak[(rule, b["aa"].shape[1])] = torch.cuda.max_memory_allocated() / 2 ** 20
        times = {(rule, i): [] for rule in names_ for i in range(len(rules[rule]))}
        for _ in range(10):
            for rule in names_:
                for i, b in enumerate(rules[rule]):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    m = train_step(model, optimizer, b, weights, g)
                    torch.cuda.synchronize()
                    times[(rule, i)].append(time.perf_counter() - t0)
        check(np.isfinite(float(m["loss"])), f"{phase}: non-finite loss in the timed steps")
        for rule in names_:
            bs = rules[rule]
            padded = sum(b["aa"].numel() for b in bs)
            real_res = sum(int(b["res_mask"].sum()) for b in bs)
            total = sum(sum(times[(rule, i)]) for i in range(len(bs)))
            per_b = ", ".join(
                f"L={b['aa'].shape[1]} {1e3 * np.mean(times[(rule, i)]):.3f} ms/step "
                f"{B / np.mean(times[(rule, i)]):.3f} samples/s peak "
                f"{peak[(rule, b['aa'].shape[1])]:.0f} MiB" for i, b in enumerate(bs))
            say(phase, f"padding [{prof_name}] {rule}: waste {padded / real_res - 1:.4f}, "
                       f"{1e3 * total / (10 * len(bs)):.3f} ms/step, "
                       f"{10 * len(bs) * B / total:.3f} samples/s over {10 * len(bs)} steps in "
                       f"turns on {card}; {per_b}")
        del model, optimizer


def prod_train_cfg() -> dict:
    """The ``train`` section of configs/learn_angle_tpu.yaml (with defaults)."""
    from pepflowww_torch.config import load_train_config

    return load_train_config(os.path.join(ROOT, "configs", "learn_angle_tpu.yaml"))[1]["train"]


# The dp phase: the losses of a world of one over NCCL against the same run
# without --dp, iteration by iteration, and the loss and grad_norm of two
# gloo ranks of B=16 on one card against one process of B=32 with the same
# global noise, within this relative gap (tests/test_multihost.py's rtol for
# the JAX package's 2-process run); the two ranks' gradients per parameter
# within STEP_REL / STEP_ABS of the single process's.
DP_RTOL = 5e-3
# (samples, steps) of the dp phase's sampler runs: an odd count, padded to 4
# rows over two ranks.
DP_SAMPLES, DP_STEPS = 3, 50


def _dp_rank(yamls: list) -> dict:
    """One of two ranks on card 0 over gloo (phase "dp", step 2): for each
    profile in `yamls`, one ``train_step`` of its 16 rows of the B=32
    batch with the global noise: this rank's launches, metrics, the digest
    of its reduced (clipped) gradients and, on rank 0, the gradients; then
    ``dp_euler_sample`` of two synthetic complexes x DP_SAMPLES rows, with
    this rank's launches and, on rank 0, the gathered rows."""
    import hashlib

    import numpy as np
    import torch

    from pepflowww_torch import native
    from pepflowww_torch.config import load_config
    from pepflowww_torch.data.collate import device_batch, pad_and_collate, replicate_item
    from pepflowww_torch.data.synthetic import make_complex
    from pepflowww_torch.models.flow import build_model, draw_noise
    from pepflowww_torch.parallel import dist, dp
    from pepflowww_torch.profile_sampler import main_path_batch, production_model
    from pepflowww_torch.sampling import dp_euler_sample
    from pepflowww_torch.training.optim import Optimizer
    from pepflowww_torch.training.train_step import train_step

    dev = dist.init("cuda:0", backend="gloo")
    rank, world = dist.rank(), dist.world_size()
    tc = prod_train_cfg()
    out = {"rank": rank, "train": []}
    for path in yamls:
        model = production_model(dev, load_config(path)).train()
        opt = Optimizer(model.parameters(), tc["optimizer"], tc["max_grad_norm"])
        batch, _ = main_path_batch(dev, 32, seed=7)
        noise = draw_noise(32, 64, torch.Generator(device=dev).manual_seed(8), dev)
        rows = dp.rank_rows(batch, rank, world)
        torch.cuda.synchronize()
        native.reset_launch_counts()
        m = train_step(model, opt, rows, dict(tc["loss_weights"]), noise=noise)
        torch.cuda.synchronize()
        launches = dict(native.LAUNCHES)
        m = {k: float(v) for k, v in m.items()}
        grads = {n: p.grad.float().cpu().numpy() for n, p in model.named_parameters()}
        digest = hashlib.sha256(b"".join(g.tobytes() for g in grads.values())).hexdigest()
        out["train"].append({"rows": int(rows["aa"].shape[0]), "launches": launches,
                             "metrics": m, "digest": digest,
                             "grads": grads if rank == 0 else None})
        del model, opt
    cfg = load_config(yamls[0])
    model = build_model(cfg, dev, seed=0)
    gen = dp.rank_generator(0, rank, dev)
    rng = np.random.default_rng(0)
    torch.cuda.synchronize()
    native.reset_launch_counts()
    sampled = []
    for i in range(2):
        item = make_complex(rng, pep_len=12, rec_len=48, complex_id=f"synth{i}")
        batch = device_batch(pad_and_collate(replicate_item(item, DP_SAMPLES)), dev)
        o = dp_euler_sample(model, batch, gen, num_steps=DP_STEPS)
        if o is not None:
            sampled.append((int(o["trans"].shape[0]),
                            all(bool(torch.isfinite(o[k]).all())
                                for k in ("rotmats", "trans", "angles"))))
    torch.cuda.synchronize()
    out["sample_launches"] = dict(native.LAUNCHES)
    out["sampled"] = sampled
    return out


def _dp_serve_cli(card: str) -> dict:
    """``python -m pepflowww_torch.serve --dp`` as a process on the card (a
    world of one): /healthz, a burst of 4 clients x 2 requests x 8 samples,
    rank 0's launches a group from its log, and a SIGTERM that ends it."""
    import queue
    import threading
    import urllib.request

    from pepflowww_torch import serve_loadtest

    cmd = [sys.executable, "-m", "pepflowww_torch.serve", "--synthetic_weights", "--port", "0",
           "--dp"]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    lines: "queue.Queue[str]" = queue.Queue()
    threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout], daemon=True).start()
    seen = []

    def drain():
        while not lines.empty():
            seen.append(lines.get())

    try:
        port = None
        while port is None:
            try:
                line = lines.get(timeout=max(0.0, 180.0 - (time.perf_counter() - t0)))
            except queue.Empty:
                fail("dp serve: the CLI did not report its address within 180 s")
            seen.append(line)
            m = re.search(r"listening on http://[\d.]+:(\d+)", line)
            port = int(m.group(1)) if m else None
        start_s = time.perf_counter() - t0
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
        name = card.split(",")[0].strip()
        check(health.get("world_size") == 1 and health["device"].startswith("cuda")
              and name in health["device"], f"dp serve: /healthz said {health}")
        res = serve_loadtest.main(["--port", str(port), "--clients", "4", "--requests", "2",
                                   "--num_samples", "8", "--num_steps", "100", "--pep_len",
                                   str(SERVE_COMPLEX[0]), "--rec_len", str(SERVE_COMPLEX[1]),
                                   "--timeout", "300"])
        check(res["requests"] == 8 and res["errors"] == 0 and res["peptides"] == 64,
              f"dp serve: load test {res}")
        proc.send_signal(signal.SIGTERM)
        code = proc.wait(60)
        time.sleep(0.5)
        drain()
        check(code == 0, f"dp serve: the CLI exited with {code} after SIGTERM")
        groups = [(int(m.group(1)), int(m.group(2)), json.loads(m.group(3))) for m in (
            re.search(r"group bucket=64 n=(\d+)/(\d+) steps=100 .* ranks=1 "
                      r"rank0_launches=(\{.*\})", ln) for ln in seen) if m]
        # The load test's 64 rows and its throwaway first request's 8.
        check(sum(n for n, _, _ in groups) == 72, f"dp serve: groups {groups}")
        for n, padded, launched in groups:
            check(launched == {"edge_transition": 500, "distance_embed": 1},
                  f"dp serve: a group of {n}/{padded} rows launched {launched}")
        say("dp", f"serve CLI --dp: listening after {start_s:.2f} s, /healthz {health}; load "
                  f"test {json.dumps(res)}; groups (rows/padded) "
                  f"{[f'{n}/{p}' for n, p, _ in groups]}, each K2 500 and K3 1 on rank 0; "
                  f"SIGTERM: exit 0 on {card}")
        return {"edge_transition": 500 * len(groups), "distance_embed": len(groups)}
    except BaseException:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
        drain()
        print("".join(seen), file=sys.stderr, flush=True)
        raise


def phase_dp(card: str, prod, ipa, ipa_yaml: str) -> dict:
    """Data parallelism on the card (phase 8); returns the phase's launches
    by kernel entry of the kernels' line, and the runs they come from."""
    import csv
    import shutil

    import numpy as np
    import torch

    from pepflowww_torch import native, sample
    from pepflowww_torch.models.flow import draw_noise
    from pepflowww_torch.parallel import dist
    from pepflowww_torch.profile_sampler import main_path_batch, production_model
    from pepflowww_torch.training.optim import zero_nans
    from pepflowww_torch.training.train_step import loss_and_total

    t_phase = time.perf_counter()
    prod_yaml = os.path.join(ROOT, "configs", "learn_angle_tpu.yaml")
    zero = dict.fromkeys(native.SOURCES, 0)
    step = {"edge_transition": 5, "edge_transition_bwd": 5, "distance_embed": 1,
            "distance_embed_bwd": 1}
    fwd = {"edge_transition": 5, "distance_embed": 1}

    def want_of(steps, vals, fused):
        s = {**step, "ipa2": 6, "ipa2_bwd": 6} if fused else step
        f = {**fwd, "ipa2": 6} if fused else fwd
        return {**zero, **{k: steps * s.get(k, 0) + vals * f.get(k, 0) for k in s}}

    # 1. The train CLI with --dp in a world of one over NCCL, then without.
    root = os.path.join(OUT_DIR, "dp_logs")
    shutil.rmtree(root, ignore_errors=True)
    common = ["--synthetic", "--batch_size", "32", "--log_freq", "1"]
    runs, launched = {}, {}
    for tag, extra in (("dp", ["--dp"]), ("single", [])):
        runs[tag], log, _ = _train_cli(f"dp train {tag}", prod_yaml, common + [
            "--max_iters", "6", "--val_freq", "6", "--logdir", os.path.join(root, tag), *extra],
            want_of(6, 2, False))
        launched[tag] = dict(native.LAUNCHES)
        check(f"world size: 1 | backend: {'nccl' if tag == 'dp' else None} |" in log,
              f"dp train {tag}: no world size and backend line")
    losses, sps = {}, {}
    for tag, run in runs.items():
        with open(os.path.join(run, "metrics.jsonl")) as f:
            recs = sps[tag] = [r for r in map(json.loads, f) if r["tag"] == "train"]
        losses[tag] = {r["step"]: r["loss"] for r in recs}
    check(set(losses["dp"]) == set(losses["single"]) == set(range(1, 7)), f"dp: {losses}")
    gap = max(abs(losses["dp"][i] / losses["single"][i] - 1) for i in range(1, 7))
    say("dp", f"train CLI --dp (world of one, NCCL) against the same run without --dp, B=32 "
              f"L=64, 6 iterations: losses {[round(losses['dp'][i], 4) for i in range(1, 7)]} "
              f"vs {[round(losses['single'][i], 4) for i in range(1, 7)]}, largest relative "
              f"gap {gap:.3e} (limit {DP_RTOL}) on {card}")
    check(gap <= DP_RTOL, "dp: the --dp losses left the single-process run's")
    # ms/step of iterations 2-6 (the first warms the allocator), from the samples/s
    # each logs: host data, the step and the log's one wait for the card.
    ms = {tag: [1e3 * 32 / r["samples_per_sec"] for r in recs[1:]]
          for tag, recs in sps.items()}
    say("dp", "train CLI ms/step at iterations 2-6, B=32 L=64, production profile: "
              + "; ".join(f"{tag} {', '.join(f'{t:.3f}' for t in ts)} (median "
                          f"{float(np.median(ts)):.3f})" for tag, ts in ms.items())
              + f" on {card}")
    dirs = os.listdir(os.path.join(root, "dp"))
    check(len(dirs) == 1 and os.path.isfile(os.path.join(root, "dp", dirs[0], "checkpoints",
                                                         "6.pt")),
          f"dp: run directories {dirs}, or no checkpoint 6.pt")
    runs["ipa"], _, _ = _train_cli("dp train ipa", ipa_yaml, common + [
        "--max_iters", "3", "--val_freq", "3", "--logdir", os.path.join(root, "ipa"), "--dp"],
        want_of(3, 2, True))
    launched["ipa"] = dict(native.LAUNCHES)
    with open(os.path.join(runs["ipa"], "metrics.jsonl")) as f:
        losses["ipa"] = {r["step"]: r["loss"] for r in map(json.loads, f) if r["tag"] == "train"}
    for ckpts in glob.glob(os.path.join(root, "*", "*", "checkpoints")):
        shutil.rmtree(ckpts)   # 82 MB each: keep the output directory small

    # 2. Two ranks sharing the card over gloo, B=16 each, against one process of B=32.
    t0 = time.perf_counter()
    ranks = dist.launch(_dp_rank, 2, ([prod_yaml, ipa_yaml],))
    say("dp", f"two gloo ranks on the one card (two processes sharing one GPU, not a scaling "
              f"figure): {time.perf_counter() - t0:.1f} s with their start on {card}")
    dev = torch.device("cuda", 0)
    tc = prod_train_cfg()
    for i, (label, cfg, fused) in enumerate((("production", prod, False),
                                             ("fused IPA", ipa, True))):
        got = [r["train"][i] for r in ranks]
        want_step = {**zero, **({**step, "ipa2": 6, "ipa2_bwd": 6} if fused else step)}
        for r, g in enumerate(got):
            check(g["rows"] == 16 and g["launches"] == want_step,
                  f"dp {label} rank {r}: {g['rows']} rows, launched {g['launches']}, expected "
                  f"{want_step}")
        check(got[0]["digest"] == got[1]["digest"],
              f"dp {label}: the two ranks' reduced gradients differ")
        model = production_model(dev, cfg).train()
        batch, _ = main_path_batch(dev, 32, seed=7)
        noise = draw_noise(32, 64, torch.Generator(device=dev).manual_seed(8), dev)
        total, _ = loss_and_total(model, batch, dict(tc["loss_weights"]), noise=noise)
        total.backward()
        total = float(total.detach())
        zero_nans(model.parameters())
        want_g = {n: p.grad.float() for n, p in model.named_parameters()}
        G = float(torch.stack([g.norm() for g in want_g.values()]).norm())
        m = got[0]["metrics"]
        loss_gap, norm_gap = abs(m["loss"] / total - 1), abs(m["grad_norm"] / G - 1)
        clip = min(1.0, float(tc["max_grad_norm"]) / (m["grad_norm"] + 1e-6))
        worst, worst_name = 0.0, ""
        for n, g in want_g.items():
            dg = float((torch.from_numpy(got[0]["grads"][n]).to(dev) / clip - g).norm())
            excess = dg / (STEP_REL * float(g.norm()) + STEP_ABS * G)
            if excess > worst:
                worst, worst_name = excess, n
        say("dp", f"{label} step, two gloo ranks x B=16 against one process x B=32 (the same "
                  f"weights and global noise): loss {m['loss']:.6f} vs {total:.6f} (gap "
                  f"{loss_gap:.3e}), grad_norm {m['grad_norm']:.6f} vs {G:.6f} (gap "
                  f"{norm_gap:.3e}), limit {DP_RTOL}; every parameter's gradient within "
                  f"{STEP_REL} ||g|| + {STEP_ABS} x global, closest {worst_name} at {worst:.3f} "
                  f"of it; reduced gradients bit-identical on both ranks "
                  f"({got[0]['digest'][:12]}); launches a rank {got[0]['launches']} on {card}")
        check(loss_gap <= DP_RTOL and norm_gap <= DP_RTOL and worst <= 1.0,
              f"dp {label}: the two ranks' step left the single process's")
        del model
    want_s = {**zero, "edge_transition": 2 * 5 * DP_STEPS, "distance_embed": 2}
    for r, res in enumerate(ranks):
        check(res["sample_launches"] == want_s,
              f"dp sampler rank {r}: launched {res['sample_launches']}, expected {want_s}")
    check(ranks[0]["sampled"] == [(DP_SAMPLES, True)] * 2 and ranks[1]["sampled"] == [],
          f"dp sampler: rank 0 gathered {ranks[0]['sampled']}")
    say("dp", f"dp_euler_sample, two gloo ranks, 2 complexes x {DP_SAMPLES} samples (padded to "
              f"4 rows), {DP_STEPS} steps: {DP_SAMPLES} finite rows a complex on rank 0; "
              f"launches a rank {want_s} on {card}")

    # 3. The sample CLI with --dp in a world of one.
    out_dir = os.path.join(OUT_DIR, "dp_samples")
    shutil.rmtree(out_dir, ignore_errors=True)
    native.reset_launch_counts()
    t0 = time.perf_counter()
    sample.main(["--config", prod_yaml, "--synthetic", "--dp", "--num_samples", str(DP_SAMPLES),
                 "--num_steps", str(DP_STEPS), "--max_complexes", "2", "--out", out_dir])
    torch.cuda.synchronize()
    launched["sample"] = dict(native.LAUNCHES)
    check(launched["sample"] == want_s,
          f"dp sample CLI: launched {launched['sample']}, expected {want_s}")
    with open(os.path.join(out_dir, "outputs.csv")) as f:
        rows = list(csv.DictReader(f))
    per = {c: sum(r["id"] == c for r in rows) for c in ("synth0", "synth1")}
    check(per == {"synth0": DP_SAMPLES, "synth1": DP_SAMPLES} and len(rows) == 2 * DP_SAMPLES
          and all(np.isfinite(float(r["ca_rmsd"])) for r in rows),
          f"dp sample CLI: outputs.csv rows {per}")
    say("dp", f"sample CLI --dp (world of one): {per} rows in outputs.csv, finite; launches "
              f"{launched['sample']}; {time.perf_counter() - t0:.1f} s on {card}")

    # 4. The server with --dp as a process.
    served = _dp_serve_cli(card)
    say("dp", f"phase took {time.perf_counter() - t_phase:.1f} s on {card}")
    return {"edge_transition": (launched["sample"]["edge_transition"], "sample CLI --dp"),
            "distance_embed": (launched["sample"]["distance_embed"], "sample CLI --dp"),
            "edge_transition_k1": (launched["dp"]["edge_transition"], "train CLI --dp"),
            "edge_transition_bwd": (launched["dp"]["edge_transition_bwd"], "train CLI --dp"),
            "distance_embed_bwd": (launched["dp"]["distance_embed_bwd"], "train CLI --dp"),
            "ipa2": (launched["ipa"]["ipa2"], "fused-IPA train CLI --dp"),
            "ipa2_bwd": (launched["ipa"]["ipa2_bwd"], "fused-IPA train CLI --dp"),
            "serve": served, "losses": losses}


# The fsdp_tp phase: the --fsdp train CLI's losses in a world of one against
# the dp phase's runs (one data rank: the same arithmetic, the clip's norm
# summed in float64 over the flat block instead of the flat buffer), and the
# --tp 1 run's against the plain profile's without it (the same model and
# code path), within this relative gap at every iteration.
FSDP_RTOL = 1e-5
# (samples, steps) of the TP sampler's and the --tp 1 server's runs.
TP_SAMPLES, TP_STEPS = 8, 20


def _settled_bytes(dev) -> int:
    """``torch.cuda.memory_allocated`` once freed tensors are returned: the
    caching allocator counts a freed block that a collective's stream used
    until its event is seen, which it checks on the next allocation."""
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize(dev)
    torch.empty(1, device=dev)
    return torch.cuda.memory_allocated(dev)


def _warm_blas(dev) -> None:
    """A float32 and a bf16 Linear's forward and backward: the matrix
    libraries' workspaces (32 MiB a handle on this card, one for the
    forward's thread and one for the backward's) exist before a
    measurement of what the model itself holds."""
    import torch

    for dt in (torch.float32, torch.bfloat16):
        lin = torch.nn.Linear(64, 64, device=dev, dtype=dt)
        lin(torch.randn(64, 64, device=dev, dtype=dt, requires_grad=True)).sum().backward()
    torch.cuda.synchronize(dev)


def _fsdp_tp_rank(prod_yaml: str, plain32_yaml: str) -> dict:
    """One of two ranks on card 0 over gloo (phase "fsdp_tp", step 2):
    whether gloo takes CUDA tensors in the two collectives FSDP uses; one
    ``--fsdp`` step of its 16 rows of the B=32 L=64 batch (launches,
    metrics, the state it holds, rank 0's gradients); one ``--tp 2`` step
    of the B=32 L=128 batch, plain profile (the pair rows its
    EdgeTransitions and IPAs received, its peak memory, rank 0's
    gradients); the TP sampler of the fp32 plain profile."""
    import warnings

    import numpy as np
    import torch

    from pepflowww_torch import native
    from pepflowww_torch.config import load_config
    from pepflowww_torch.data.collate import device_batch, pad_and_collate, replicate_item
    from pepflowww_torch.data.synthetic import make_complex
    from pepflowww_torch.models.flow import build_model, draw_noise
    from pepflowww_torch.models.ipa import EdgeTransition, InvariantPointAttention
    from pepflowww_torch.parallel import dist, dp, fsdp, tp
    from pepflowww_torch.profile_sampler import main_path_batch, production_model
    from pepflowww_torch.sampling import dp_euler_sample
    from pepflowww_torch.training.optim import Optimizer
    from pepflowww_torch.training.train_step import train_step

    dev = dist.init("cuda:0", backend="gloo")
    rank = dist.rank()
    out = {"rank": rank, "probe": {}}
    for name, size, fn in (("all_gather", 8, dist.all_gather_into),
                           ("reduce_scatter", 2, dist.reduce_scatter_into)):
        try:
            fn(torch.empty(size, device=dev), torch.ones(4, device=dev))
            torch.cuda.synchronize()
        except (RuntimeError, NotImplementedError, ValueError) as e:
            raise RuntimeError(f"gloo refuses CUDA tensors in {name}: {e}") from e
        out["probe"][name] = "takes CUDA tensors"
    tc = prod_train_cfg()
    weights = dict(tc["loss_weights"])

    def grads_of(model, opt, m):
        clip = min(1.0, float(tc["max_grad_norm"]) / (m["grad_norm"] + 1e-6))
        names = [n for n, _ in model.named_parameters()]
        if opt.sharded:
            per = opt._per_param(opt.shard.grad)
        else:
            per = [p.grad.float().cpu() for _, p in model.named_parameters()]
        return {n: g.numpy() / clip for n, g in zip(names, per)}

    # 1. --fsdp: two data ranks, B=16 each.
    dist.setup_grid(1)
    _warm_blas(dev)
    base = _settled_bytes(dev)
    model = production_model(dev, load_config(prod_yaml)).train()
    opt = fsdp.ShardedOptimizer(model.parameters(), tc["optimizer"], tc["max_grad_norm"])
    prepared = _settled_bytes(dev) - base
    batch, _ = main_path_batch(dev, 32, seed=7)
    noise = draw_noise(32, 64, torch.Generator(device=dev).manual_seed(8), dev)
    rows = dp.rank_rows(batch, rank, 2)
    torch.cuda.synchronize()
    native.reset_launch_counts()
    m = train_step(model, opt, rows, weights, noise=noise)
    torch.cuda.synchronize()
    launches = dict(native.LAUNCHES)
    m = {k: float(v) for k, v in m.items()}
    grads = grads_of(model, opt, m)   # every rank: the blocks are gathered
    grads = grads if rank == 0 else None
    opt.shard.grad = None
    del rows, noise, batch
    held = _settled_bytes(dev) - base
    big = sorted(b["size"] for seg in torch.cuda.memory_snapshot() for b in seg["blocks"]
                 if b["state"] == "active_allocated" and b["size"] >= 1 << 20)
    m2 = train_step(model, opt, dp.rank_rows(main_path_batch(dev, 32, seed=7)[0], rank, 2),
                    weights, noise=draw_noise(32, 64, torch.Generator(device=dev).manual_seed(8),
                                              dev))
    del m2
    opt.shard.grad = None
    held2 = _settled_bytes(dev) - base
    moments = [v for k, v in opt.opt.state[opt.shard].items() if k != "step"]
    out["fsdp"] = {"launches": launches, "metrics": m, "grads": grads, "held_bytes": held,
                   "prepared_bytes": prepared, "held2_bytes": held2, "big_blocks": big,
                   "state_bytes": 4 * (opt.shard.numel() + sum(v.numel() for v in moments)),
                   "numel": opt.numel, "span": opt.span, "block": opt.shard.numel(),
                   "param_bytes": sum(p.untyped_storage().nbytes() for p in model.parameters())}
    del model, opt, moments
    torch.cuda.empty_cache()

    # 2. --tp 2: one data rank of two model ranks, B=32 L=128, the plain profile.
    dist.setup_grid(2)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        plain = tp.plain_profile(load_config(prod_yaml))
    model = production_model(dev, plain).train()
    seen = []
    for name, mod in model.named_modules():
        if isinstance(mod, (EdgeTransition, InvariantPointAttention)):
            mod.register_forward_hook(
                lambda mod, args, o, name=name: seen.append(tuple(args[1].shape)))
    opt = Optimizer(model.parameters(), tc["optimizer"], tc["max_grad_norm"])
    batch, _ = main_path_batch(dev, 32, seed=7, complex_=(12, 116, 128))
    noise = draw_noise(32, 128, torch.Generator(device=dev).manual_seed(8), dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    native.reset_launch_counts()
    t0 = time.perf_counter()
    m = train_step(model, opt, batch, weights, noise=noise)
    torch.cuda.synchronize()
    m = {k: float(v) for k, v in m.items()}
    out["tp"] = {"launches": dict(native.LAUNCHES), "metrics": m, "seen": sorted(set(seen)),
                 "calls": len(seen), "seconds": time.perf_counter() - t0,
                 "peak_bytes": torch.cuda.max_memory_allocated(dev) - base,
                 "warnings": [str(r.message) for r in rec],
                 "grads": grads_of(model, opt, m) if rank == 0 else None}
    del model, opt, batch, noise
    torch.cuda.empty_cache()

    # 3. The TP sampler, fp32 plain profile, one data rank of two model ranks.
    model = build_model(load_config(plain32_yaml), dev, seed=0)
    item = make_complex(np.random.default_rng(0), pep_len=12, rec_len=48, complex_id="tp")
    sb = device_batch(pad_and_collate(replicate_item(item, TP_SAMPLES)), dev)
    native.reset_launch_counts()
    o = dp_euler_sample(model, sb, dp.rank_generator(0, dist.grid().data_rank, dev),
                        num_steps=TP_STEPS)
    torch.cuda.synchronize()
    out["sample_launches"] = dict(native.LAUNCHES)
    out["sample"] = None if o is None else {k: v.numpy() for k, v in o.items()}
    return out


def _tp_serve_cli(card: str) -> dict:
    """``python -m pepflowww_torch.serve --tp 1`` as a process on the card:
    its warning and start-up line, /healthz with the grid, one request of
    TP_SAMPLES samples and TP_STEPS steps answered with no kernel launched
    on rank 0, and a SIGTERM that ends it."""
    import queue
    import threading
    import urllib.request

    import numpy as np

    from pepflowww_torch.data.collate import mask_select_data
    from pepflowww_torch.data.pdb import save_pdb
    from pepflowww_torch.data.synthetic import make_complex

    cmd = [sys.executable, "-m", "pepflowww_torch.serve", "--synthetic_weights", "--port", "0",
           "--tp", "1"]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    lines: "queue.Queue[str]" = queue.Queue()
    threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout], daemon=True).start()
    seen = []
    try:
        port = None
        while port is None:
            try:
                line = lines.get(timeout=max(0.0, 180.0 - (time.perf_counter() - t0)))
            except queue.Empty:
                fail("tp serve: the CLI did not report its address within 180 s")
            seen.append(line)
            m = re.search(r"listening on http://[\d.]+:(\d+)", line)
            port = int(m.group(1)) if m else None
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
        check(health.get("tp", {}).get("model_ranks") == 1
              and health["tp"].get("profile") == "plain" and health.get("world_size") == 1,
              f"tp serve: /healthz said {health}")
        item = make_complex(np.random.default_rng(3), pep_len=SERVE_COMPLEX[0],
                            rec_len=SERVE_COMPLEX[1])
        req = {"pocket_pdb": save_pdb(mask_select_data(item, ~item["generate_mask"])),
               "peptide_pdb": save_pdb(mask_select_data(item, item["generate_mask"])),
               "num_samples": TP_SAMPLES, "num_steps": TP_STEPS}
        code, body = _serve_post(port, req)
        check(code == 200 and len(body.get("pdbs", [])) == TP_SAMPLES
              and all(np.isfinite(body["metrics"]["ca_rmsd"])),
              f"tp serve: the request returned {code} {str(body)[:300]}")
        proc.send_signal(signal.SIGTERM)
        code = proc.wait(60)
        time.sleep(0.5)
        while not lines.empty():
            seen.append(lines.get())
        text = "".join(seen)
        check(code == 0, f"tp serve: the CLI exited with {code} after SIGTERM")
        check("Pallas-profile kernels" in text and "pair rows over 1 model ranks" in text,
              "tp serve: no profile warning or no grid in its start-up lines")
        groups = [json.loads(m.group(1)) for m in re.finditer(
            rf"steps={TP_STEPS} .* ranks=1 rank0_launches=(\{{.*\}})", text)]
        check(groups == [{}], f"tp serve: groups and rank 0's launches {groups}")
        say("fsdp_tp", f"serve CLI --tp 1: /healthz {health}; {TP_SAMPLES} samples x "
                       f"{TP_STEPS} steps answered, {len(body['pdbs'])} PDBs, rank 0 launched "
                       f"nothing; SIGTERM: exit 0 on {card}")
        return {}
    except BaseException:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
        print("".join(seen), file=sys.stderr, flush=True)
        raise


def phase_fsdp_tp(card: str, dp: dict, ipa_yaml: str) -> dict:
    """FSDP and pair-row TP on the card (phase 9); returns, by kernel entry
    of the kernels' line, its launches under --fsdp and under --tp."""
    import shutil
    import warnings

    import numpy as np
    import torch

    from pepflowww_torch import native
    from pepflowww_torch.config import load_config
    from pepflowww_torch.data.collate import device_batch, pad_and_collate, replicate_item
    from pepflowww_torch.data.synthetic import make_complex
    from pepflowww_torch.models.flow import build_model, draw_noise
    from pepflowww_torch.parallel import dist, dp as dp_rows, tp
    from pepflowww_torch.profile_sampler import main_path_batch, production_model
    from pepflowww_torch.sampling import euler_sample
    from pepflowww_torch.training.optim import Optimizer
    from pepflowww_torch.training.train_step import train_step

    t_phase = time.perf_counter()
    prod_yaml = os.path.join(ROOT, "configs", "learn_angle_tpu.yaml")
    plain_yaml = write_config("learn_angle_tpu_plain", use_pallas=False)
    plain32_yaml = write_config("learn_angle_tpu_plain_fp32", use_pallas=False, dtype=None)
    zero = dict.fromkeys(native.SOURCES, 0)
    step = {"edge_transition": 5, "edge_transition_bwd": 5, "distance_embed": 1,
            "distance_embed_bwd": 1}
    fwd = {"edge_transition": 5, "distance_embed": 1}

    def want_of(steps, vals, fused):
        s = {**step, "ipa2": 6, "ipa2_bwd": 6} if fused else step
        f = {**fwd, "ipa2": 6} if fused else fwd
        return {**zero, **{k: steps * s.get(k, 0) + vals * f.get(k, 0) for k in s}}

    def losses_of(run):
        shutil.rmtree(os.path.join(run, "checkpoints"), ignore_errors=True)   # 82 MB each
        with open(os.path.join(run, "metrics.jsonl")) as f:
            return {r["step"]: r["loss"] for r in map(json.loads, f) if r["tag"] == "train"}

    def gap(a, b):
        check(set(a) == set(b), f"fsdp_tp: iterations {sorted(a)} vs {sorted(b)}")
        return max(abs(a[i] / b[i] - 1) for i in a)

    # 1. The train CLI with --fsdp, and with --tp 1, in a world of one over NCCL.
    root = os.path.join(OUT_DIR, "fsdp_tp_logs")
    shutil.rmtree(root, ignore_errors=True)
    common = ["--synthetic", "--batch_size", "32", "--log_freq", "1"]
    launched = {}
    runs = {}
    for tag, yaml_path, iters, fused, against in (("fsdp", prod_yaml, 6, False, "single"),
                                                  ("fsdp ipa", ipa_yaml, 3, True, "ipa")):
        runs[tag], log, _ = _train_cli(f"fsdp_tp train {tag}", yaml_path, common + [
            "--max_iters", str(iters), "--val_freq", str(iters), "--logdir",
            os.path.join(root, tag.replace(" ", "_")), "--fsdp"], want_of(iters, 2, fused))
        launched[tag] = dict(native.LAUNCHES)
        check("grid: 1 data x 1 model ranks | fsdp: True | tp: off" in log
              and "world size: 1 | backend: nccl |" in log, f"fsdp_tp {tag}: no grid line")
        mine, ref = losses_of(runs[tag]), dp["losses"][against]
        g = gap(mine, ref)
        say("fsdp_tp", f"train CLI --{tag} (world of one, NCCL), B=32 L=64, {iters} iterations: "
                       f"losses {[round(mine[i], 6) for i in sorted(mine)]} against the dp "
                       f"phase's {'run without --dp' if against == 'single' else '--dp run'}, "
                       f"largest relative gap {g:.3e} (limit {FSDP_RTOL}) on {card}")
        check(g <= FSDP_RTOL, f"fsdp_tp {tag}: the --fsdp losses left the unsharded run's")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        runs["tp1"], log, _ = _train_cli("fsdp_tp train tp 1", prod_yaml, common + [
            "--max_iters", "3", "--val_freq", "3", "--logdir", os.path.join(root, "tp1"),
            "--tp", "1"], zero)
    launched["tp1"] = dict(native.LAUNCHES)
    msgs = [str(r.message) for r in rec if "Pallas" in str(r.message)]
    check(msgs == [tp.PROFILE_WARNING] and "kernels off" in log,
          f"fsdp_tp tp 1: warnings {msgs}, or no 'kernels off' in the log")
    runs["plain"], _, _ = _train_cli("fsdp_tp train plain", plain_yaml, common + [
        "--max_iters", "3", "--val_freq", "3", "--logdir", os.path.join(root, "plain")], zero)
    g = gap(losses_of(runs["tp1"]), losses_of(runs["plain"]))
    say("fsdp_tp", f"train CLI --tp 1 on the production YAML: the warning \"{msgs[0]}\"; no "
                   f"kernel launched; losses against the use_pallas: false run's, largest "
                   f"relative gap {g:.3e} (limit {FSDP_RTOL}) on {card}")
    check(g <= FSDP_RTOL, "fsdp_tp tp 1: the losses left the plain profile's")

    # 2. Two ranks sharing the card over gloo, against one process.
    t0 = time.perf_counter()
    ranks = dist.launch(_fsdp_tp_rank, 2, (prod_yaml, plain32_yaml))
    say("fsdp_tp", f"two gloo ranks on the one card (two processes sharing one GPU: "
                   f"correctness and memory, not a scaling figure): {time.perf_counter() - t0:.1f}"
                   f" s with their start; gloo with CUDA tensors: {ranks[0]['probe']} on {card}")
    dev = torch.device("cuda", 0)
    tc = prod_train_cfg()
    weights = dict(tc["loss_weights"])

    def single_step(cfg, B, L, complex_):
        """One process's step: (metrics, gradients before the clip, bytes
        of parameters and moments after it, peak bytes of the step)."""
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
        model = production_model(dev, cfg).train()
        opt = Optimizer(model.parameters(), tc["optimizer"], tc["max_grad_norm"])
        batch, _ = main_path_batch(dev, B, seed=7, complex_=complex_)
        noise = draw_noise(B, L, torch.Generator(device=dev).manual_seed(8), dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        t = time.perf_counter()
        m = {k: float(v) for k, v in train_step(model, opt, batch, weights, noise=noise).items()}
        torch.cuda.synchronize()
        sec = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated(dev) - before
        clip = min(1.0, float(tc["max_grad_norm"]) / (m["grad_norm"] + 1e-6))
        grads = {n: p.grad.float().cpu().numpy() / clip for n, p in model.named_parameters()}
        for p in model.parameters():
            p.grad = None
        opt._flat, opt._views = None, []
        del batch, noise
        held = _settled_bytes(dev) - base
        del model, opt
        torch.cuda.empty_cache()
        return m, grads, held, peak, sec

    def closest(got, want):
        G = float(np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2)) for g in want.values())))
        worst, name = 0.0, ""
        for n, g in want.items():
            excess = float(np.linalg.norm(got[n] - g)) / (STEP_REL * float(np.linalg.norm(g))
                                                          + STEP_ABS * G)
            if excess > worst:
                worst, name = excess, n
        return worst, name

    prod = load_config(prod_yaml)
    m1, g1, held1, _, _ = single_step(prod, 32, 64, (12, 48, 64))
    f = [r["fsdp"] for r in ranks]
    want_step = {**zero, **step}
    for r, x in enumerate(f):
        check(x["launches"] == want_step, f"fsdp_tp fsdp rank {r}: launched {x['launches']}")
        check(x["block"] == -(-x["span"] // 2) and x["param_bytes"] == 0,
              f"fsdp_tp fsdp rank {r}: block {x['block']} of {x['numel']}, whole parameters "
              f"still hold {x['param_bytes']} bytes")
    m = f[0]["metrics"]
    loss_gap, norm_gap = abs(m["loss"] / m1["loss"] - 1), abs(m["grad_norm"] / m1["grad_norm"] - 1)
    worst, worst_name = closest(f[0]["grads"], g1)
    N = f[0]["numel"]
    say("fsdp_tp", f"--fsdp step, two gloo ranks x B=16 against one process x B=32 (the same "
                   f"weights and global noise): loss {m['loss']:.6f} vs {m1['loss']:.6f} (gap "
                   f"{loss_gap:.3e}), grad_norm {m['grad_norm']:.6f} vs {m1['grad_norm']:.6f} "
                   f"(gap {norm_gap:.3e}), limit {DP_RTOL}; every parameter's gradient within "
                   f"{STEP_REL} ||g|| + {STEP_ABS} x global, closest {worst_name} at {worst:.3f} "
                   f"of it; launches a rank {f[0]['launches']} on {card}")
    say("fsdp_tp", f"--fsdp memory a rank after the step (gradients dropped): parameters' block "
                   f"+ two moments {f[0]['state_bytes']} and {f[1]['state_bytes']} bytes "
                   f"(N = {N} parameters, {f[0]['span']} with the 128-byte gaps: one process "
                   f"holds 3 x N x 4 = {12 * N} bytes), "
                   f"torch.cuda.memory_allocated over the run's start after prepare "
                   f"{f[0]['prepared_bytes']} and after the step {f[0]['held_bytes']} and "
                   f"{f[1]['held_bytes']} (after a second step {f[0]['held2_bytes']}; blocks of "
                   f"1 MiB or more {f[0]['big_blocks']}) bytes against one process's {held1} (ratio "
                   f"{f[0]['held_bytes'] / held1:.3f}; the kernels' cached bf16 operands "
                   f"included); whole parameters between steps: 0 bytes; on {card}")
    check(loss_gap <= DP_RTOL and norm_gap <= DP_RTOL and worst <= 1.0,
          "fsdp_tp fsdp: the two ranks' step left the single process's")
    check(all(x["state_bytes"] == 12 * x["block"] for x in f)
          and all(x["held_bytes"] <= 0.55 * held1 for x in f),
          "fsdp_tp fsdp: a rank holds more than about half of one process's state")

    plain = tp.plain_profile(prod)
    m2, g2, _, peak2, sec2 = single_step(plain, 32, 128, (12, 116, 128))
    t = [r["tp"] for r in ranks]
    for r, x in enumerate(t):
        check(x["launches"] == zero and x["seen"] == [(32, 64, 128, 64)] and x["calls"] == 11
              and x["warnings"] == [tp.PROFILE_WARNING],
              f"fsdp_tp tp rank {r}: launches {x['launches']}, pair tensors {x['seen']} in "
              f"{x['calls']} calls, warnings {x['warnings']}")
    m = t[0]["metrics"]
    loss_gap, norm_gap = abs(m["loss"] / m2["loss"] - 1), abs(m["grad_norm"] / m2["grad_norm"] - 1)
    worst, worst_name = closest(t[0]["grads"], g2)
    say("fsdp_tp", f"--tp 2 step, one data x two model ranks on the one card, B=32 L=128, the "
                   f"plain profile: every EdgeTransition and IPA received {t[0]['seen']} pair "
                   f"tensors (64 of 128 rows); loss {m['loss']:.6f} vs one process's "
                   f"{m2['loss']:.6f} (gap {loss_gap:.3e}), grad_norm gap {norm_gap:.3e} (limit "
                   f"{DP_RTOL}); closest gradient {worst_name} at {worst:.3f} of its limit; peak "
                   f"memory of the step a rank {t[0]['peak_bytes']} and {t[1]['peak_bytes']} "
                   f"bytes against one process's {peak2} (ratio "
                   f"{t[0]['peak_bytes'] / peak2:.3f}); {t[0]['seconds']:.3f} s a step (two "
                   f"processes sharing one GPU, gloo) against {sec2:.3f} s; no kernel launched; "
                   f"on {card}")
    check(loss_gap <= DP_RTOL and norm_gap <= DP_RTOL and worst <= 1.0,
          "fsdp_tp tp: the two model ranks' step left the single process's")

    model = build_model(load_config(plain32_yaml), dev, seed=0)
    item = make_complex(np.random.default_rng(0), pep_len=12, rec_len=48, complex_id="tp")
    sb = device_batch(pad_and_collate(replicate_item(item, TP_SAMPLES)), dev)
    want = euler_sample(model, sb, dp_rows.rank_generator(0, 0, dev), num_steps=TP_STEPS)
    want = {k: v.cpu().numpy() for k, v in want.items()}
    got = ranks[0]["sample"]
    check(got is not None and ranks[1]["sample"] is None
          and all(r["sample_launches"] == zero for r in ranks),
          "fsdp_tp: the TP sampler's rows or launches")
    dt = float(np.abs(got["trans"] - want["trans"]).max())
    dr = float(np.abs(got["rotmats"] - want["rotmats"]).max())
    diff = int((got["seqs"] != want["seqs"]).sum())
    say("fsdp_tp", f"TP sampler, one data x two model ranks, fp32 plain profile, {TP_SAMPLES} "
                   f"samples x {TP_STEPS} steps, L=64, seed 0, against one process's at the same "
                   f"seed: max |trans gap| {dt:.3e} A, max |rotmats gap| {dr:.3e}, tokens "
                   f"differing {diff} of {got['seqs'].size}; on {card}")
    check(dt <= 5e-5 and dr <= 5e-5 and diff == 0, "fsdp_tp: the TP sampler left one process's")
    del model

    # 3. The server with --tp 1 as a process.
    served = _tp_serve_cli(card)
    say("fsdp_tp", f"phase took {time.perf_counter() - t_phase:.1f} s on {card}")
    fsdp_launches = {"edge_transition": 0, "edge_transition_k1": launched["fsdp"]["edge_transition"],
                     "distance_embed": launched["fsdp"]["distance_embed"],
                     "edge_transition_bwd": launched["fsdp"]["edge_transition_bwd"],
                     "distance_embed_bwd": launched["fsdp"]["distance_embed_bwd"],
                     "ipa2": launched["fsdp ipa"]["ipa2"],
                     "ipa2_bwd": launched["fsdp ipa"]["ipa2_bwd"]}
    tp_total = {k: launched["tp1"].get(k, 0) + sum(r["tp"]["launches"].get(k, 0)
                                                   + r["sample_launches"].get(k, 0)
                                                   for r in ranks) + served.get(k, 0)
                for k in native.SOURCES}
    return {"fsdp": fsdp_launches, "tp": tp_total}


# The pp phase: pipeline stages and microbatches of the --pp runs, and the
# peptide, pocket and padded length of their batch (the loader's 128 bucket).
PP_STAGES, PP_MICRO, PP_COMPLEX = 2, 4, (12, 116, 128)


# One rank of the pp phase's probe: a CUDA tensor through gloo's send and recv.
PP_PROBE = """
import datetime, sys, torch, torch.distributed as tdist
sys.path.insert(0, {root!r})
from pepflowww_torch.parallel import dist
dev = dist.init("cuda:0", backend="gloo", timeout=datetime.timedelta(seconds=20))
x = torch.arange(4.0, device=dev)
if dist.rank() == 0:
    tdist.send(x, 1)
else:
    buf = torch.zeros(4, device=dev)
    tdist.recv(buf, 0)
    torch.cuda.synchronize()
    print("received", buf.tolist(), flush=True)
print("sent or received", flush=True)
"""


def _pp_probe() -> list:
    """Whether gloo's send and recv take CUDA tensors (phase "pp", step 1):
    two processes on card 0, each its own interpreter, since a gloo I/O
    error in its transport thread ends the process. Returns each rank's
    exit code and the line that says what happened. The port's hops do not
    depend on the answer: over a gloo group they go through host buffers
    (``dist.hop_on_host``)."""
    import resource

    from pepflowww_torch.parallel import dist

    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(dist.free_port()), WORLD_SIZE="2")
    procs = [subprocess.Popen([sys.executable, "-c", PP_PROBE.format(root=ROOT)], cwd=ROOT,
                              env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              preexec_fn=lambda: resource.setrlimit(resource.RLIMIT_CORE, (0, 0)))
             for r in range(2)]
    out = []
    for p in procs:
        try:
            text = p.communicate(timeout=90)[0]
        except subprocess.TimeoutExpired:
            p.kill()
            text = p.communicate()[0] + "\n(killed after 90 s)"
        lines = [ln.strip() for ln in text.splitlines() if ln.strip()]
        said = next((ln for ln in lines if any(w in ln for w in ("what()", "Bad address",
                                                                 "Error", "received"))),
                    lines[-1] if lines else "")
        out.append({"code": p.returncode, "said": said[:240]})
    return out


def _pp_rank(prod_yaml: str, sharded: bool) -> dict:
    """One rank on card 0 over gloo (phase "pp"): ``--pp 2`` on two ranks,
    or ``--pp 2 --fsdp`` on four (`sharded`), one step of this data rank's
    rows of the B=32 L=128 batch, then a second, timed. Returns the launches,
    the metrics, rank 0's gradients (before the clip; unsharded only), the
    peak memory of the first step over the rank's start, the state a
    sharded rank holds, the hop transport and the profile's warnings."""
    import warnings

    import torch

    from pepflowww_torch import native
    from pepflowww_torch.config import load_config
    from pepflowww_torch.models.flow import draw_noise
    from pepflowww_torch.parallel import dist, dp, fsdp, pp
    from pepflowww_torch.profile_sampler import main_path_batch, production_model
    from pepflowww_torch.training.optim import Optimizer
    from pepflowww_torch.training.train_step import train_step

    dev = dist.init("cuda:0", backend="gloo")
    g = dist.setup_grid(1, PP_STAGES)
    tc = prod_train_cfg()
    weights = dict(tc["loss_weights"])
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        cfg = pp.plain_profile(load_config(prod_yaml))
    _warm_blas(dev)
    model = production_model(dev, cfg).train()
    opt = (fsdp.ShardedOptimizer if sharded else Optimizer)(
        model.parameters(), tc["optimizer"], tc["max_grad_norm"])
    batch, _ = main_path_batch(dev, 32, seed=7, complex_=PP_COMPLEX)
    noise = draw_noise(32, PP_COMPLEX[2], torch.Generator(device=dev).manual_seed(8), dev)
    rows = dp.rank_rows(batch, g.data_rank, g.n_data)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    native.reset_launch_counts()
    m = train_step(model, opt, rows, weights, noise=noise, n_micro=PP_MICRO)
    torch.cuda.synchronize()
    out = {"rank": dist.rank(), "data_rank": g.data_rank, "pipe_rank": g.pipe_rank,
           "launches": dict(native.LAUNCHES), "metrics": {k: float(v) for k, v in m.items()},
           "peak_bytes": torch.cuda.max_memory_allocated(dev) - base,
           "transport": "host buffers (gloo)" if dist.hop_on_host() else "device tensors",
           "warnings": [str(r.message) for r in rec], "grads": None}
    if sharded:
        moments = [v for k, v in opt.opt.state[opt.shard].items() if k != "step"]
        out.update(block=opt.shard.numel(), span=opt.span,
                   state_bytes=4 * (opt.shard.numel() + sum(v.numel() for v in moments)))
    elif dist.rank() == 0:
        clip = min(1.0, float(tc["max_grad_norm"]) / (out["metrics"]["grad_norm"] + 1e-6))
        out["grads"] = {n: p.grad.float().cpu().numpy() / clip
                        for n, p in model.named_parameters()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train_step(model, opt, rows, weights, noise=noise, n_micro=PP_MICRO)
    torch.cuda.synchronize()
    out["step_s"] = time.perf_counter() - t0
    out["launches2"] = dict(native.LAUNCHES)
    return out


def _pp_single(cfg, tc: dict, dev) -> tuple:
    """One process's plain-profile step on the pp phase's batch and noise:
    (metrics, gradients before the clip, peak bytes of the step, seconds
    of a second step)."""
    import torch

    from pepflowww_torch.models.flow import draw_noise
    from pepflowww_torch.profile_sampler import main_path_batch, production_model
    from pepflowww_torch.training.optim import Optimizer
    from pepflowww_torch.training.train_step import train_step

    weights = dict(tc["loss_weights"])
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    model = production_model(dev, cfg).train()
    opt = Optimizer(model.parameters(), tc["optimizer"], tc["max_grad_norm"])
    batch, _ = main_path_batch(dev, 32, seed=7, complex_=PP_COMPLEX)
    noise = draw_noise(32, PP_COMPLEX[2], torch.Generator(device=dev).manual_seed(8), dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    m = {k: float(v) for k, v in train_step(model, opt, batch, weights, noise=noise).items()}
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev) - before
    clip = min(1.0, float(tc["max_grad_norm"]) / (m["grad_norm"] + 1e-6))
    grads = {n: p.grad.float().cpu().numpy() / clip for n, p in model.named_parameters()}
    t0 = time.perf_counter()
    train_step(model, opt, batch, weights, noise=noise)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    del model, opt, batch, noise
    torch.cuda.empty_cache()
    return m, grads, peak, sec


def phase_pp(card: str) -> dict:
    """GPipe pipeline parallelism on the card (phase 10); returns the
    launches of every kernel in the phase's ranks (all 0)."""
    import numpy as np
    import torch

    from pepflowww_torch import native
    from pepflowww_torch.config import load_config
    from pepflowww_torch.parallel import dist, pp

    t_phase = time.perf_counter()
    prod_yaml = os.path.join(ROOT, "configs", "learn_angle_tpu.yaml")
    zero = dict.fromkeys(native.SOURCES, 0)
    dev = torch.device("cuda", 0)
    tc = prod_train_cfg()

    # 1. Does gloo's point-to-point take CUDA tensors? (A probe: the port's
    # hops over gloo go through host buffers whatever it answers.)
    probe = _pp_probe()
    say("pp", f"gloo send/recv with CUDA tensors, two processes on the card: rank 0 exit "
              f"{probe[0]['code']}: {probe[0]['said']}; rank 1 exit {probe[1]['code']}: "
              f"{probe[1]['said']}; the port's hops over a gloo group go through host buffers "
              f"(dist.hop_on_host), over NCCL as device tensors (not runnable here: NCCL puts "
              f"no two ranks on one GPU); on {card}")

    # 2. --pp 2 over two ranks sharing the card, against one process.
    t0 = time.perf_counter()
    ranks = dist.launch(_pp_rank, 2, (prod_yaml, False))
    t_two = time.perf_counter() - t0
    cfg = pp.plain_profile(load_config(prod_yaml))
    m1, g1, peak1, sec1 = _pp_single(cfg, tc, dev)
    for r in ranks:
        check(r["transport"] == "host buffers (gloo)", f"pp rank {r['rank']}: {r['transport']}")
        check(r["launches"] == zero and r["launches2"] == zero,
              f"pp rank {r['rank']}: launched {r['launches']}, then {r['launches2']}")
        check(r["warnings"] == [pp.PROFILE_WARNING], f"pp rank {r['rank']}: {r['warnings']}")
        check(r["metrics"] == ranks[0]["metrics"], "pp: the two ranks' metrics differ")
    m = ranks[0]["metrics"]
    loss_gap = abs(m["loss"] / m1["loss"] - 1)
    norm_gap = abs(m["grad_norm"] / m1["grad_norm"] - 1)
    G = float(np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2)) for g in g1.values())))
    worst, worst_name = 0.0, ""
    for n, g in g1.items():
        share = float(np.linalg.norm(ranks[0]["grads"][n] - g)) / (
            STEP_REL * float(np.linalg.norm(g)) + STEP_ABS * G)
        if share > worst:
            worst, worst_name = share, n
    Bm = 32 // PP_MICRO
    L = PP_COMPLEX[2]
    edge_bytes = 2 if cfg.ipa.compute_dtype == torch.bfloat16 else 4
    hop = Bm * L * (cfg.ipa.c_s + 12) * 4 + Bm * L * L * cfg.ipa.c_z * edge_bytes
    say("pp", f"--pp 2, two gloo ranks on the one card ({cfg.ipa.num_blocks // PP_STAGES} "
              f"blocks a stage, B=32 L={L}, {PP_MICRO} microbatches of {Bm}, bubble {(PP_STAGES - 1) / (PP_MICRO + PP_STAGES - 1):.3f}; "
              f"the production YAML as the plain profile, warning \"{ranks[0]['warnings'][0][:60]}...\"; "
              f"stage hops through {ranks[0]['transport']}, {hop} bytes a hop, "
              f"{PP_MICRO} forward and {PP_MICRO} backward a step) against one process: loss "
              f"{m['loss']:.6f} vs {m1['loss']:.6f} (gap {loss_gap:.3e}), grad_norm "
              f"{m['grad_norm']:.6f} vs {m1['grad_norm']:.6f} (gap {norm_gap:.3e}), limit "
              f"{DP_RTOL}; closest gradient {worst_name} at {worst:.3f} of its limit; kernel "
              f"launches a rank over two steps {sum(ranks[0]['launches2'].values())}; on {card}")
    say("pp", f"--pp 2 peak memory of the step over a rank's start: stage 0 "
              f"{ranks[0]['peak_bytes']}, stage 1 {ranks[1]['peak_bytes']} bytes against one "
              f"process's {peak1} (ratios {ranks[0]['peak_bytes'] / peak1:.3f}, "
              f"{ranks[1]['peak_bytes'] / peak1:.3f}); a second step {ranks[0]['step_s']:.3f} s "
              f"(two processes sharing one GPU, hops through gloo's host copies: not a scaling "
              f"figure) against one process's {sec1:.3f} s; the launch {t_two:.1f} s with its "
              f"start; on {card}")
    check(loss_gap <= DP_RTOL and norm_gap <= DP_RTOL and worst <= 1.0,
          "pp: the two stages' step left the single process's")

    # 3. --pp 2 --fsdp over four ranks (2 data x 2 pipe), B=16 a data rank.
    t0 = time.perf_counter()
    four = dist.launch(_pp_rank, 4, (prod_yaml, True))
    t_four = time.perf_counter() - t0
    for r in four:
        check(r["launches"] == zero and r["launches2"] == zero,
              f"pp fsdp rank {r['rank']}: launched {r['launches']}")
        check(r["block"] == -(-r["span"] // 2) and r["state_bytes"] == 12 * r["block"],
              f"pp fsdp rank {r['rank']}: block {r['block']} of {r['span']}, state "
              f"{r['state_bytes']} bytes")
    gaps = [abs(r["metrics"]["loss"] / m1["loss"] - 1) for r in four]
    say("pp", f"--pp 2 --fsdp, 2 data x 2 pipe gloo ranks on the one card, B=16 a data rank, "
              f"{PP_MICRO} microbatches of 4: loss {four[0]['metrics']['loss']:.6f} vs one "
              f"process's {m1['loss']:.6f} at B=32 (largest gap over the ranks "
              f"{max(gaps):.3e}, limit {DP_RTOL}); state a rank (block and two moments) "
              f"{[r['state_bytes'] for r in four]} bytes (a block of {four[0]['block']} of "
              f"{four[0]['span']}); peak memory of the step {[r['peak_bytes'] for r in four]} "
              f"bytes; a second step {four[0]['step_s']:.3f} s; the launch {t_four:.1f} s; on "
              f"{card}")
    check(max(gaps) <= DP_RTOL, "pp fsdp: the four ranks' loss left the single process's")

    # 4. The train CLI on this one-GPU world.
    outs = {}
    for tag, flags, words in (("world", ["--pp", "2"], "--pp 2 must divide the world size 1"),
                              ("tp", ["--pp", "2", "--tp", "2"], pp.PP_TP)):
        res = subprocess.run([sys.executable, "-m", "pepflowww_torch.train", "--synthetic",
                              "--logdir", os.path.join(OUT_DIR, "pp_logs"), *flags], cwd=ROOT,
                             capture_output=True, text=True, timeout=300)
        outs[tag] = res.returncode
        check(res.returncode != 0 and words in res.stderr,
              f"pp CLI {' '.join(flags)}: exit {res.returncode}, {res.stderr[-600:]}")
    say("pp", f"train CLI --pp 2 on this one-GPU world: exit {outs['world']}, \"--pp 2 must "
              f"divide the world size 1\"; --pp 2 --tp 2: exit {outs['tp']} with the JAX CLI's "
              f"words; phase took {time.perf_counter() - t_phase:.1f} s on {card}")
    # launches2: both steps (the counts run on from the reset before the first)
    return {k: sum(r["launches2"].get(k, 0) for r in ranks + four) for k in native.SOURCES}


def phase_eval(card: str):
    """The evaluation CLI over the data phase's samples (phase 10)."""
    import csv

    import numpy as np

    from pepflowww_torch import evalrun, native

    samples, structs = os.path.join(OUT_DIR, "samples"), os.path.join(OUT_DIR, "structs")
    for tools in ("ss", "auto"):
        out = os.path.join(OUT_DIR, f"eval_{tools}")
        native.reset_launch_counts()
        t0 = time.perf_counter()
        summary = evalrun.main(["--samples_dir", samples, "--structure_dir", structs,
                                "--tools", tools, "--out", out])
        wall = time.perf_counter() - t0
        launched = {k: v for k, v in native.LAUNCHES.items() if v}
        check(not launched, f"eval: evalrun launched {launched}")
        with open(os.path.join(out, "eval_outputs.csv"), newline="") as f:
            rows = list(csv.DictReader(f))
        check(len(rows) == 192 and all(np.isfinite(float(r["ss_recovery"])) for r in rows),
              f"eval --tools {tools}: {len(rows)} rows, or a non-finite ss_recovery")
        on_disk = json.load(open(os.path.join(out, "eval_summary.json")))
        absent = {k for k, v in on_disk["tools"].items() if v != "ok"}
        want = set() if tools == "ss" else {"tm", "tmscore", "foldx", "rosetta", "scwrl4"}
        check(on_disk == json.loads(json.dumps(summary)) and on_disk["tools"].get("ss") == "ok"
              and absent == want and all(on_disk["tools"][t].startswith("unavailable")
                                         for t in absent),
              f"eval --tools {tools}: tools {on_disk['tools']}")
        say("eval", f"--tools {tools}: {len(rows)} rows, finite ss_recovery (mean "
                    f"{np.mean([float(r['ss_recovery']) for r in rows]):.4f}); tools "
                    f"{ {k: v.split(':')[0] for k, v in on_disk['tools'].items()} }; "
                    f"{wall:.2f} s wall on the host of {card}; no kernel launched")


# The serve phase's complexes, (peptide, pocket): the load test's (bucket 64)
# and the two-bucket burst's (buckets 32 and 128).
SERVE_COMPLEX = (12, 48)
SERVE_BUCKETS = {32: (8, 20), 128: (12, 110)}


def _pdb_residues(pdb: str) -> tuple:
    """(residues, peptide residues in chain A) of a PDB's ATOM records; a
    malformed record (no finite coordinates) fails the run."""
    atoms = [ln for ln in pdb.splitlines() if ln.startswith("ATOM")]
    xyz = [[float(ln[30:38]), float(ln[38:46]), float(ln[46:54])] for ln in atoms]
    check(bool(atoms) and all(map(math.isfinite, sum(xyz, []))), "serve: malformed ATOM records")
    return (len({(ln[21], ln[22:27]) for ln in atoms}),
            len({ln[22:27] for ln in atoms if ln[21] == "A"}))


def _serve_post(port: int, obj: dict, timeout: float = 300.0) -> tuple:
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}/sample",
                                 data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _serve_cli(card: str, yaml_path: str, pocket_pdb: str):
    """Serve 1: ``python -m pepflowww_torch.serve`` as a process on the card."""
    import queue
    import threading
    import urllib.request

    cmd = [sys.executable, "-m", "pepflowww_torch.serve", "--synthetic_weights", "--port", "0",
           "--config", yaml_path]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    lines: "queue.Queue[str]" = queue.Queue()
    threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout], daemon=True).start()
    seen = []
    try:
        port = None
        while port is None:
            try:
                line = lines.get(timeout=max(0.0, 180.0 - (time.perf_counter() - t0)))
            except queue.Empty:
                fail("serve: the CLI did not report its address within 180 s")
            seen.append(line)
            m = re.search(r"listening on http://[\d.]+:(\d+)", line)
            port = int(m.group(1)) if m else None
        start_s = time.perf_counter() - t0
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
        name = card.split(",")[0].strip()
        check(health["status"] == "ok" and health["device"].startswith("cuda")
              and name in health["device"], f"serve: /healthz said {health}")
        t1 = time.perf_counter()
        code, out = _serve_post(port, {"pocket_pdb": pocket_pdb, "peptide_len": 12,
                                       "num_samples": 2, "num_steps": 100})
        first_s = time.perf_counter() - t1
        check(code == 200 and len(out["pdbs"]) == 2, f"serve: CLI request gave {code}")
        check(all(_pdb_residues(p)[1] == 12 for p in out["pdbs"]),
              "serve: the CLI's PDBs lack 12 residues in chain A")
        code, err = _serve_post(port, {"pocket_pdb": "garbage"})
        check(code == 400 and "error" in err, f"serve: garbage gave {code} {err}")
        say("serve", f"CLI: listening after {start_s:.2f} s, /healthz {health}; peptide_len 12 "
                     f"x 2 samples, 100 steps: 200 in {first_s:.2f} s (first request of the "
                     f"process), 2 PDBs with 12 residues in chain A; garbage: {code} {err}")
    except BaseException:
        proc.kill()
        proc.wait(30)
        while not lines.empty():
            seen.append(lines.get())
        print("".join(seen), file=sys.stderr, flush=True)
        raise
    finally:
        if proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(30)


class _counted_sampler:
    """Within the block, every group the server runs is recorded in
    `groups` as (bucket, rows, padded rows, seconds), every group sampler
    it builds records each call's rows and the launches made during it in
    `calls` (exact when groups run one at a time), and every response's
    PDBs are checked as the server sends them: a malformed one becomes a
    400, which the load test counts."""

    def __enter__(self):
        from pepflowww_torch import native, serve

        self.serve, self.calls, self.groups = serve, [], []
        self.saved = (serve._make_group_sampler, serve._sample, serve._run_group)
        real_make, real_sample, real_group = self.saved

        def make(steps):
            fn = real_make(steps)

            def run(model, batch, generator):
                before = dict(native.LAUNCHES)
                out = fn(model, batch, generator)
                self.calls.append((int(batch["aa"].shape[0]), {
                    k: v - before[k] for k, v in native.LAUNCHES.items() if v != before[k]}))
                return out
            return run

        def sample(state, req):
            out = real_sample(state, req)
            for pdb in out["pdbs"]:
                _pdb_residues(pdb)
            return out

        def group(state, key, rows, contexts):
            t0 = time.perf_counter()
            out = real_group(state, key, rows, contexts)
            self.groups.append((key[0], len(rows), serve._group_pad_size(len(rows)),
                                time.perf_counter() - t0))
            return out

        serve._make_group_sampler, serve._sample, serve._run_group = make, sample, group
        return self

    def __exit__(self, *exc):
        (self.serve._make_group_sampler, self.serve._sample,
         self.serve._run_group) = self.saved


def _serve_launch_check(tag: str, groups: list, per_chunk: dict, totals: dict) -> list:
    """The launches since the last reset against `groups` (the
    (bucket, rows, padded rows, seconds) of the groups run since):
    `per_chunk` for each 64-row chunk, nothing else. Adds them to `totals`;
    returns the groups' real row counts."""
    from pepflowww_torch import native

    chunks = sum(-(-padded // 64) for _, _, padded, _ in groups)
    want = {**dict.fromkeys(native.SOURCES, 0), **{k: v * chunks for k, v in per_chunk.items()}}
    got = dict(native.LAUNCHES)
    check(got == want, f"{tag}: launched {got}, expected {want} for {len(groups)} groups "
                       f"({chunks} chunks of <= 64 rows)")
    for k, v in got.items():
        totals[k] = totals.get(k, 0) + v
    return [n for _, n, _, _ in groups]


@contextlib.contextmanager
def _serving(state):
    """An HTTP server of `state` on a free local port, in a thread; yields
    the port."""
    import threading

    from pepflowww_torch import serve

    srv = serve._Server(("127.0.0.1", 0), state)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        yield srv.server_address[1]
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(60)


def _serve_burst(tag: str, state, clients: int, requests: int, samples: int) -> dict:
    """The port's load test against an in-process server of `state`."""
    from pepflowww_torch import serve_loadtest

    with _serving(state) as port:
        res = serve_loadtest.main(["--port", str(port), "--clients", str(clients), "--requests",
                                   str(requests), "--num_samples", str(samples), "--num_steps",
                                   "100", "--pep_len", str(SERVE_COMPLEX[0]), "--rec_len",
                                   str(SERVE_COMPLEX[1]), "--timeout", "300"])
    check(res["requests"] == clients * requests and res["errors"] == 0
          and res["peptides"] == clients * requests * samples,
          f"{tag}: load test {res}")
    return res


def phase_serve(card: str, prod, int8, ipa, yamls: dict, main_pps: float, k_ms: dict) -> dict:
    """The server on the card (phase 11); returns the serve phase's launches
    by kernel (in-process runs: ladder, load tests, two buckets, over-cap).
    `k_ms`: the kernels phase's ms a call by kernel, printed beside the
    serve shapes' device times."""
    import concurrent.futures

    import numpy as np
    import torch

    from pepflowww_torch import native, serve
    from pepflowww_torch.data.collate import mask_select_data, replicate_item
    from pepflowww_torch.data.pdb import save_pdb
    from pepflowww_torch.data.synthetic import make_complex
    from pepflowww_torch.profile_sampler import production_model

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    zero = dict.fromkeys(native.SOURCES, 0)
    prod_chunk = {"edge_transition": 500, "distance_embed": 1}
    totals: dict = {}

    def pdbs(pep, rec, seed):
        item = make_complex(np.random.default_rng(seed), pep_len=pep, rec_len=rec)
        return (save_pdb(mask_select_data(item, item["generate_mask"])),
                save_pdb(mask_select_data(item, ~item["generate_mask"])))

    _serve_cli(card, yamls["production"], pdbs(*SERVE_COMPLEX, seed=0)[1])

    # 2. The warm ladder in-process, then size 1 again.
    with _counted_sampler() as counted:
        native.reset_launch_counts()
        state = serve.start(serve._parser().parse_args(["--warmup", "64", "--config",
                                                        yamls["production"]]),
                            model=production_model(dev, prod))
        sizes = [n for n, _ in counted.calls]
        check(sizes == serve.warmup_sizes() == [1, 2, 4, 8, 16, 32, 64],
              f"serve: ladder ran {sizes}")
        for n, got in counted.calls:
            check({**zero, **got} == {**zero, **prod_chunk},
                  f"serve ladder n={n}: launched {got}, expected {prod_chunk}")
        _serve_launch_check("serve ladder", counted.groups, prod_chunk, totals)
        cold = {n: sec for _, n, _, sec in counted.groups}
        native.reset_launch_counts()
        item = make_complex(np.random.default_rng(1), pep_len=8, rec_len=40)
        serve._run_group(state, (64, 100), replicate_item(item, 1), [None])
        _serve_launch_check("serve warm n=1", counted.groups[-1:], prod_chunk, totals)
        warm = counted.groups[-1][3]
    say("serve", "ladder (production, bucket 64, 100 steps), seconds a size, first use: "
                 + ", ".join(f"n={n} {sec:.3f}" for n, sec in cold.items())
                 + f"; n=1 again, warm: {warm:.3f}; each group K2 500, K3 1, nothing else; "
                 + card)

    # 3. The load test against the in-process server.
    with _counted_sampler() as counted:
        native.reset_launch_counts()
        t0 = time.perf_counter()
        # 2 requests a client (the JAX tool's 4 halved) keep the script in its time.
        res = _serve_burst("serve load", state, 8, 2, 8)
        wall = time.perf_counter() - t0
        merged = _serve_launch_check("serve load", counted.groups, prod_chunk, totals)
    say("serve", f"load test (production, 8 clients x 2 requests x 8 samples, 100 steps, "
                 f"peptide {SERVE_COMPLEX[0]} + pocket {SERVE_COMPLEX[1]}, bucket 64): "
                 f"{json.dumps(res)}; {wall:.2f} s with its first request; groups (rows, the "
                 f"first request's first) {merged}; main phase's production B=64 L=64 "
                 f"{main_pps:.3f} peptides/s in this call; {card}")

    # 4. Two buckets at once.
    burst = {b: pdbs(*SERVE_BUCKETS[b], seed=20 + b) for b in SERVE_BUCKETS}
    reqs = [(b, {"pocket_pdb": burst[b][1], "peptide_pdb": burst[b][0], "num_samples": 2,
                 "num_steps": 100}) for _ in range(8) for b in SERVE_BUCKETS]
    with _serving(state) as port:
        with _counted_sampler() as counted:
            native.reset_launch_counts()
            with concurrent.futures.ThreadPoolExecutor(len(reqs)) as ex:
                outs = list(ex.map(lambda r: _serve_post(port, r[1]), reqs))
            _serve_launch_check("serve two buckets", counted.groups, prod_chunk, totals)
        groups = [g[:3] for g in counted.groups]
        for (b, _), (code, out) in zip(reqs, outs):
            check(code == 200 and len(out["pdbs"]) == 2, f"serve two buckets: {code}")
            check(all(_pdb_residues(p)[0] == sum(SERVE_BUCKETS[b]) for p in out["pdbs"]),
                  f"serve two buckets: a bucket-{b} response holds another complex")
        for b in SERVE_BUCKETS:
            check(sum(n for g, n, _ in groups if g == b) == 16,
                  f"serve two buckets: bucket {b} ran {groups}")
        say("serve", f"two buckets, 8 requests x 2 samples each at 32 and 128 sent together: "
                     f"every row once; groups (bucket, rows, padded) {groups}")

        # 5. One request over the cap.
        with _counted_sampler() as counted:
            native.reset_launch_counts()
            t0 = time.perf_counter()
            code, out = _serve_post(port, {
                "pocket_pdb": pdbs(*SERVE_COMPLEX, seed=0)[1], "peptide_len": SERVE_COMPLEX[0],
                "num_samples": 100, "num_steps": 100})
            sec = time.perf_counter() - t0
        check(code == 200 and len(out["pdbs"]) == 100
              and all(_pdb_residues(p)[1] == SERVE_COMPLEX[0] for p in out["pdbs"]),
              f"serve over cap: {code}, or PDBs without {SERVE_COMPLEX[0]} residues in chain A")
        check([g[:3] for g in counted.groups] == [(64, 100, 128)],
              f"serve over cap: {counted.groups}")
        _serve_launch_check("serve over cap", counted.groups, prod_chunk, totals)
        check(native.LAUNCHES["edge_transition"] == 1000 and native.LAUNCHES["distance_embed"] == 2,
              "serve over cap: not two 64-row chunks")
        say("serve", f"num_samples 100: one group of 100 rows padded to 128, two 64-row chunks "
                     f"(K2 1000, K3 2), 100 PDBs in {sec:.2f} s")

    # 6. The int8 and fused-IPA profiles.
    for name, cfg, per_chunk in (
            ("int8", int8, {"edge_transition_int8": 500, "distance_embed": 1}),
            ("fused IPA", ipa, {"ipa2": 600, **prod_chunk})):
        with _counted_sampler() as counted:
            other = serve.start(serve._parser().parse_args(["--config", yamls[name]]),
                                model=production_model(dev, cfg))
            check(other.profile == name, f"serve: {yamls[name]} started {other.profile}")
            native.reset_launch_counts()
            res = _serve_burst(f"serve {name}", other, 4, 2, 8)
            merged = _serve_launch_check(f"serve {name}", counted.groups, per_chunk, totals)
        say("serve", f"{name} profile: 4 clients x 2 requests x 8 samples, bucket 64: "
                     f"{res['peptides_per_sec']} peptides/s, p50 {res['latency_s']['p50']} s; "
                     f"groups {merged}; each chunk {per_chunk}, nothing else")

    _serve_kernels(card, dev, k_ms)
    say("serve", f"the serve phase took {time.perf_counter() - t_phase:.1f} s")
    return totals


# (peptide, pocket) of the complexes whose pair features the serve phase's
# kernel checks feed K3, by bucket.
SERVE_KERNEL_COMPLEXES = {32: SERVE_BUCKETS[32], 64: SERVE_COMPLEX, 128: SERVE_BUCKETS[128]}


def _serve_kernels(card: str, dev, k_ms: dict):
    """K2 and K3 against their plain versions at the batches the server pads
    to (B = 1, 2, 4, 16) in the buckets 32, 64 and 128, K6 and K7 at the
    int8 and fused-IPA bursts' (B = 8, 16, 32) in bucket 64; K2's and K3's
    device time a call at B = 1, 2, 4 in bucket 64 (calls queued behind a
    sleep kernel) beside the kernels phase's B=64 time. None of these
    launches is a serve launch."""
    import numpy as np
    import torch

    from pepflowww_torch.data.collate import device_batch
    from pepflowww_torch.data.synthetic import make_batch
    from pepflowww_torch.kernel_times import device_ms
    from pepflowww_torch.models import cuda_dist, cuda_edge, cuda_ipa

    times, errs = [], dict.fromkeys(("K2", "K3", "K6", "K7"), 0.0)
    for L, (pep, rec) in SERVE_KERNEL_COMPLEXES.items():
        for B in (1, 2, 4, 16):
            edge, nb, mask, p, ro = _edge_inputs(B, L, dev, seed=3000 + 10 * B + L)
            ops = cuda_edge.kernel_operands(p, ro)
            tag = f"serve edge_transition+readout B={B} L={L}"
            k2 = lambda: cuda_edge.fused_edge_transition(edge, nb, mask, p, readout=ro, ops=ops)
            for n, a, b in zip(("out", "b", "pz"), _launch_once("edge_transition", k2, tag),
                               cuda_edge.edge_transition_plain(edge, nb, mask, p, torch.bfloat16,
                                                               ro)):
                errs["K2"] = max(errs["K2"], compare(f"{tag} [{n}]", a, b, EDGE_TOL))
            bt = device_batch(make_batch(np.random.default_rng(3100 + B + L), batch_size=B,
                                         pep_len=pep, rec_len=rec, pad_to=L), dev)
            args = (bt["pos_heavyatom"] * 0.1, bt["mask_heavyatom"].float(), bt["aa"],
                    bt["mask_heavyatom"][:, :, 1].float() * (~bt["generate_mask"]).float())
            dp = _dist_inputs(B, L, dev, seed=3200 + B + L)[1]
            dops = cuda_dist.kernel_operands(dp)
            tag = f"serve distance_embed B={B} L={L} ({pep} + {rec} residues)"
            k3 = lambda: cuda_dist.fused_distance_embed(*args, dp, ops=dops)
            errs["K3"] = max(errs["K3"], compare(
                tag, _launch_once("distance_embed", k3, tag),
                cuda_dist.distance_embed_plain(*args, dp, torch.bfloat16), DIST_TOL))
            if L == 64 and B <= 4:
                times.append(f"B={B} K2 {1e3 * device_ms(k2):.1f} us, "
                             f"K3 {1e3 * device_ms(k3):.1f} us")
    for B in (8, 16, 32):
        edge, nb, mask, p, ro = _edge_inputs(B, 64, dev, seed=3300 + B)
        ops = cuda_edge.kernel_operands(p, ro, quant_int8=True)
        tag = f"serve edge_transition_int8+readout B={B} L=64"
        got = _launch_once("edge_transition_int8", lambda: cuda_edge.fused_edge_transition_int8(
            edge, nb, mask, p, readout=ro, ops=ops), tag)
        want = cuda_edge.edge_transition_int8_plain(edge, nb, mask, p, torch.bfloat16, ro)
        for n, a, b in zip(("out", "b", "pz"), got, want):
            errs["K6"] = max(errs["K6"], compare(f"{tag} [{n}]", a, b, EDGE_TOL))
        args = _ipa_inputs(B, 64, dev, seed=3400 + B, layout="sampler")
        tag = f"serve ipa2 B={B} L=64 (sampler layout)"
        got = _launch_once("ipa2", lambda: cuda_ipa.fused_ipa2(*args), tag)
        for n, a, b in zip(("o", "optl", "norm", "opair"), got, cuda_ipa.ipa2_plain(*args)):
            errs["K7"] = max(errs["K7"], compare(f"{tag} [{n}]", a, b, IPA_TOL))
    say("serve", "K2 and K3 agree with their plain versions at B = 1, 2, 4, 16 and L = 32, 64, "
                 "128, K6 and K7 at B = 8, 16, 32 and L = 64; max abs error "
                 + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
                 + "; device time a call at L=64: "
                 + "; ".join(times) + f" (B=64, the kernels phase, CUDA events: K2 "
                 f"{1e3 * k_ms['edge_transition']:.1f} us, K3 {1e3 * k_ms['distance_embed']:.1f} "
                 f"us); {card}")


# The widths phase: the width sweep's widths (c_z = F = 64 w) at its
# batches (kernel_times.WIDTH_BATCHES: B = 64, 32, 8 at L = 64). K1, K2 and
# K3 are held to their plain versions with EDGE_TOL and DIST_TOL as at 1x
# (bf16 outputs: a hidden activation that rounds to the other bf16
# neighbour in one of the two moves an output by about one bf16 step of
# the hidden layer's scale; the wider sums change the rounding points'
# values, not their number); K4 and K5 with BWD_REL and bit-identical
# across two calls.
WIDTHS = (2, 4, 8)
WIDE_STEPS = 20          # the sweep's sampler: 20 Euler steps (scaled to 100 for its rate)
WIDE_NAMES = {"K1": "edge_transition_k1", "K2": "edge_transition", "K3": "distance_embed",
              "K4": "edge_transition_bwd", "K5": "distance_embed_bwd"}


def _widths_kernels(card: str, w: int) -> dict:
    """K1-K5 at width `w` against their plain versions, the device kernels
    of one call (the library's count of its launches), and their device
    times."""
    import torch

    from pepflowww_torch import native
    from pepflowww_torch.kernel_times import WIDTH_BATCHES, device_ms, wide_calls
    from pepflowww_torch.models import cuda_dist, cuda_edge

    dev = torch.device("cuda", 0)
    B = WIDTH_BATCHES[w]
    rows = {}
    for name, (call, plain, (bound, by), per_call, counter) in wide_calls(w, B, dev, 40 + w).items():
        tag = f"{name} w={w} B={B} L=64"
        got = _launch_once(counter, call, tag)
        if name in ("K1", "K2", "K3"):
            want = plain()
            got, want = (got, want) if name == "K2" else ((got,), (want,))
            tol = DIST_TOL if name == "K3" else EDGE_TOL
            err = max(compare(f"{tag} [{n}]", a, b, tol, phase="widths")
                      for n, a, b in zip(("out", "b", "pz"), got, want))
        elif name == "K4":
            flat = lambda r: (r[0], r[1], *(r[2][k] for k in cuda_edge.PARAM_NAMES))
            err = compare_grads(tag, ("d_edge", "d_node") + cuda_edge.PARAM_NAMES, flat(got),
                                flat(plain()), flat(call()), phase="widths")
        else:
            flat = lambda r: tuple(r[k] for k in cuda_dist.PARAM_NAMES)
            err = compare_grads(tag, cuda_dist.PARAM_NAMES, flat(got), flat(plain()), flat(call()),
                                phase="widths")
        # The library's own count of the kernels it launched (each launch
        # accepted: cudaGetLastError 0); a profiler trace of these calls has
        # lost one of two launches of one name on the H100.
        launched = native.function(counter, f"{counter}_wide_launches", [])
        before = launched()
        call()
        torch.cuda.synchronize()
        check(launched() - before == per_call, f"{tag}: {launched() - before} device kernels "
                                               f"a call, {per_call} by design")
        with torch.no_grad():
            k_ms = device_ms(call)
            p_ms = cuda_ms(plain, reps=2, warmup=1)
        say("widths", f"{tag}: {per_call} device kernels a call; kernel {1e3 * k_ms:.1f} us, "
                      f"plain {1e3 * p_ms:.1f} us, bound {1e3 * bound:.1f} us by {by} "
                      f"({100 * bound / k_ms:.1f}% of bound) on {card}")
        rows[name] = dict(err=err, ms=k_ms, plain_ms=p_ms, bound_ms=bound, bound_by=by)
    torch.cuda.empty_cache()
    return rows


def _widths_model(card: str, w: int, zero: dict) -> dict:
    """The flagship architecture at width `w` (6 blocks, the production
    profile, seeded weights) through the normal entry points: a 20-step
    sampler run (K2 100 times, K3 once) and a training step (K1 5, K4 5, K3
    1, K5 1) with exact launches and finite outputs and gradients; then the
    width sweep's row of measurements for it. Returns the launches."""
    import torch

    from pepflowww_torch import native
    from pepflowww_torch.bench import width_config
    from pepflowww_torch.kernel_times import WIDTH_BATCHES
    from pepflowww_torch.models.flow import draw_noise
    from pepflowww_torch.profile_sampler import main_path_batch, production_model
    from pepflowww_torch.sampling import euler_sample
    from pepflowww_torch.training.train_step import loss_and_total
    from pepflowww_torch.width_sweep import LOSS_WEIGHTS, run_width

    dev = torch.device("cuda", 0)
    B, L = WIDTH_BATCHES[w], 64
    model = production_model(dev, width_config(w))
    batch, _ = main_path_batch(dev, B)
    native.reset_launch_counts()
    out = euler_sample(model, batch, torch.Generator(device=dev).manual_seed(1),
                       num_steps=WIDE_STEPS)
    torch.cuda.synchronize()
    sampled = dict(native.LAUNCHES)
    want = {**zero, "edge_transition": 5 * WIDE_STEPS, "distance_embed": 1}
    say("widths", f"w={w} B={B} sampler {WIDE_STEPS} steps: launches {sampled}")
    check(sampled == want, f"widths w={w}: the sampler launched {sampled}, expected {want}")
    for k in ("rotmats", "trans", "angles"):
        check(bool(torch.isfinite(out[k]).all()), f"widths w={w}: non-finite {k}")
    check(tuple(out["trans"].shape) == (B, L, 3), f"widths w={w}: unexpected output shape")

    model.train()
    noise = draw_noise(B, L, torch.Generator(device=dev).manual_seed(8), dev)
    for rep in range(2):   # the first builds the kernels' operands
        model.zero_grad(set_to_none=True)
        native.reset_launch_counts()
        total, _ = loss_and_total(model, batch, dict(LOSS_WEIGHTS), noise=noise)
        total.backward()
        torch.cuda.synchronize()
    trained = dict(native.LAUNCHES)
    want = {**zero, "edge_transition": 5, "edge_transition_bwd": 5, "distance_embed": 1,
            "distance_embed_bwd": 1}
    say("widths", f"w={w} B={B} training step: loss {float(total):.4f}, launches {trained}")
    check(trained == want, f"widths w={w}: the training step launched {trained}, expected {want}")
    missing = [n for n, p in model.named_parameters()
               if p.grad is None or not bool(torch.isfinite(p.grad).all())]
    check(not missing, f"widths w={w}: parameters without a finite gradient: {missing}")
    model.zero_grad(set_to_none=True)

    row = run_width(w, B, dev, model=model)
    check("error" not in row, f"widths w={w}: the sweep's row failed: {row}")
    say("widths", f"sweep row {json.dumps(row)} on {card}")
    del model
    torch.cuda.empty_cache()
    return {"K1": trained["edge_transition"], "K2": sampled["edge_transition"],
            "K3": sampled["distance_embed"], "K4": trained["edge_transition_bwd"],
            "K5": trained["distance_embed_bwd"]}


def phase_widths(card: str) -> dict:
    """K1-K5 and the flagship architecture at the JAX package's 2x, 4x and
    8x widths: {kernel entry name: {width: measurements and launches}}."""
    from pepflowww_torch import native

    t0 = time.perf_counter()
    zero = dict.fromkeys(native.SOURCES, 0)
    out = {entry: {} for entry in WIDE_NAMES.values()}
    for w in WIDTHS:
        rows = _widths_kernels(card, w)
        launches = _widths_model(card, w, zero)
        for name, entry in WIDE_NAMES.items():
            out[entry][str(w)] = {"launches": launches[name], "max_abs_err": rows[name]["err"],
                                  "ms": rows[name]["ms"], "plain_ms": rows[name]["plain_ms"],
                                  "bound_ms": rows[name]["bound_ms"],
                                  "bound_by": rows[name]["bound_by"]}
        say("widths", f"w={w}: " + ", ".join(
            f"{n} {1e3 * rows[n]['ms']:.1f} us (bound {1e3 * rows[n]['bound_ms']:.1f})"
            for n in WIDE_NAMES) + f" on {card}")
    say("widths", f"phase took {time.perf_counter() - t0:.1f} s")
    return out


def write_config(name: str, **ipa) -> str:
    """configs/learn_angle_tpu.yaml with the `ipa` keys set under
    model.encoder.ipa, written to chiprun_out/<name>.yaml
    (``profile_sampler.py --config`` reads it)."""
    import yaml

    with open(os.path.join(ROOT, "configs", "learn_angle_tpu.yaml")) as f:
        raw = yaml.safe_load(f)
    raw["model"]["encoder"]["ipa"].update(ipa)
    path = os.path.join(OUT_DIR, f"{name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return path


def main():
    if not os.path.isdir(os.path.join(ROOT, "pepflowww_torch")):
        print("pepflowww_torch/ is not beside chip_smoke.py: run it from a checkout",
              file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("CUDA is not available: chip_smoke.py needs an NVIDIA GPU", file=sys.stderr)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(OUT_DIR, exist_ok=True)

    card = phase_setup()
    rows = phase_kernels()
    phase_oracle()
    phase_oracle("oracle ipa", ipa=True)
    phase_oracle("oracle int8", int8=True, golden="sampler_stats_trained", seeds=(29, 30, 31))
    phase_oracle("oracle int8 nb=6", int8=True)

    from pepflowww_torch import native
    from pepflowww_torch.config import load_config

    prod = load_config(os.path.join(ROOT, "configs", "learn_angle_tpu.yaml"))
    ipa_yaml = write_config("learn_angle_tpu_ipa", use_pallas_ipa=True)
    ipa = load_config(ipa_yaml)
    check(ipa.ipa.use_pallas_ipa and ipa.ipa.use_pallas, f"{ipa_yaml}: use_pallas_ipa not read")
    int8_yaml = write_config("learn_angle_tpu_int8", quant_int8=True)
    int8 = load_config(int8_yaml)
    check(int8.ipa.quant_int8 and int8.ipa.use_pallas, f"{int8_yaml}: quant_int8 not read")
    zero = dict.fromkeys(native.SOURCES, 0)
    sampled, pps = phase_main(card, prod, "main", {**zero, "edge_transition": 500,
                                                   "distance_embed": 1})
    sampled_ipa, _ = phase_main(card, ipa, "main ipa", {**zero, "edge_transition": 500,
                                                        "distance_embed": 1, "ipa2": 600})
    sampled_int8, pps_int8 = phase_main(card, int8, "main int8",
                                        {**zero, "edge_transition_int8": 500, "distance_embed": 1})
    say("main int8", f"B=64 L=64 100 steps, peptides/s in this call: int8 profile "
                     f"{pps_int8:.3f}, production profile {pps:.3f} on {card}")
    step = {**zero, "edge_transition": 5, "edge_transition_bwd": 5, "distance_embed": 1,
            "distance_embed_bwd": 1}
    trained, ms = phase_train(card, prod, "train", step)
    trained_ipa, ms_ipa = phase_train(card, ipa, "train ipa", {**step, "ipa2": 6, "ipa2_bwd": 6})
    say("train ipa", f"B=32 L=64 ms/step in this call: fused-IPA profile {ms_ipa:.3f}, "
                     f"production profile {ms:.3f} on {card}")
    # The fused-IPA step on the L=128 bucket: K8 through its three kernels of L > 64.
    trained_long, ms_long = phase_train(card, ipa, "train ipa L=128",
                                        {**step, "ipa2": 6, "ipa2_bwd": 6},
                                        complex_=(12, 116, 128), descent=False, timed_steps=10)
    k8_per_call = native.function("ipa2_bwd", "ipa2_bwd_kernels_per_call", [ctypes.c_int])(128)
    say("train ipa L=128", f"B=32 ms/step in this call: L=128 {ms_long:.3f}, L=64 {ms_ipa:.3f} "
                           f"(fused-IPA profile) on {card}; K8 {trained_long['ipa2_bwd']} calls a "
                           f"step, {k8_per_call} kernels each")
    phase_train_int8(int8)
    phase_data(card, prod)
    phase_train_data(card, prod, ipa, ipa_yaml)
    dp = phase_dp(card, prod, ipa, ipa_yaml)
    grid = phase_fsdp_tp(card, dp, ipa_yaml)
    pp_launches = phase_pp(card)
    phase_eval(card)
    served = phase_serve(card, prod, int8, ipa, {
        "production": os.path.join(ROOT, "configs", "learn_angle_tpu.yaml"), "int8": int8_yaml,
        "fused IPA": ipa_yaml}, pps, {k: r["ms"] for k, r in rows.items()})
    widths = phase_widths(card)
    launches = {"edge_transition": sampled["edge_transition"],
                "edge_transition_k1": trained["edge_transition"],
                "distance_embed": sampled["distance_embed"],
                "edge_transition_bwd": trained["edge_transition_bwd"],
                "distance_embed_bwd": trained["distance_embed_bwd"],
                "ipa2": sampled_ipa["ipa2"], "ipa2_bwd": trained_ipa["ipa2_bwd"],
                "ipa2_bwd_long": trained_long["ipa2_bwd"],
                "edge_transition_int8": sampled_int8["edge_transition_int8"],
                "ipa1": rows["ipa1"]["checks"]}

    meta = {"edge_transition": ("pepflowww_torch/csrc/edge_transition.cu",
                                "pepflowww_tpu/models/pallas_edge.py:160"),
            "edge_transition_k1": ("pepflowww_torch/csrc/edge_transition.cu",
                                   "pepflowww_tpu/models/pallas_edge.py:160"),
            "distance_embed": ("pepflowww_torch/csrc/distance_embed.cu",
                               "pepflowww_tpu/models/pallas_dist.py:101"),
            "edge_transition_bwd": ("pepflowww_torch/csrc/edge_transition_bwd.cu",
                                    "pepflowww_tpu/models/pallas_edge_bwd.py:148"),
            "distance_embed_bwd": ("pepflowww_torch/csrc/distance_embed_bwd.cu",
                                   "pepflowww_tpu/models/pallas_dist.py:279"),
            "ipa2": ("pepflowww_torch/csrc/ipa2.cu", "pepflowww_tpu/models/pallas_ipa2.py:126"),
            "ipa2_bwd": ("pepflowww_torch/csrc/ipa2_bwd.cu",
                         "pepflowww_tpu/models/pallas_ipa2.py:344"),
            "ipa2_bwd_long": ("pepflowww_torch/csrc/ipa2_bwd.cu",
                              "pepflowww_tpu/models/pallas_ipa2.py:344"),
            "edge_transition_int8": ("pepflowww_torch/csrc/edge_transition_int8.cu",
                                     "pepflowww_tpu/models/pallas_edge.py:47"),
            "ipa1": ("pepflowww_torch/csrc/ipa1.cu", "pepflowww_tpu/models/pallas_ipa.py:66")}
    # No single PyTorch call computes any of them (library_ms null): torch._int_mm is one
    # of K6's GEMMs, and scaled_dot_product_attention gives neither K7's nor K9's o_pair.
    kernels = [{"name": name, "route": "cuda", "source": meta[name][0], "replaces": meta[name][1],
                "launches": launches[name], "max_abs_err": r["err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": None} for name, r in rows.items()]
    for k in kernels:
        if k["name"] in ("edge_transition", "distance_embed", "edge_transition_int8", "ipa2"):
            k["serve_launches"] = served.get(k["name"], 0)
        if k["name"] in dp:
            k["dp_launches"], k["dp_run"] = dp[k["name"]]
        if k["name"] in dp["serve"]:
            k["dp_serve_launches"] = dp["serve"][k["name"]]
        k["fsdp_launches"] = grid["fsdp"].get(k["name"], 0)
        k["tp_launches"] = grid["tp"].get(k["name"].removesuffix("_k1").removesuffix("_long"), 0)
        k["pp_launches"] = pp_launches.get(k["name"].removesuffix("_k1").removesuffix("_long"), 0)
        if k["name"] in widths:
            k["widths"] = widths[k["name"]]
        if k["name"] == "edge_transition":
            k["variant"] = "readout on (K2), B=64, the sampler's"
        if k["name"] == "edge_transition_k1":
            k["variant"] = "readout off (K1), B=32, the training step's"
        if k["name"] == "ipa2_bwd":
            k["variant"] = "L <= 64 (tile and pairs kernels), B=32 L=64, the training step's"
        if k["name"] == "ipa2_bwd_long":
            k["variant"] = ("L > 64 (query, key and pair kernels), B=32 L=128, the fused-IPA "
                            "training step at L=128")
        if k["name"] == "ipa1":
            k["path"] = ("none in either package (tests only): launches are the kernels "
                         "phase's checks")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
