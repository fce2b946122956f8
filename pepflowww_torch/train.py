"""Training CLI on one device: synthetic batches, the flow-matching
objective, clipped Adam with a plateau scheduler driven by a validation
split, and checkpoints in the reference layout.

    python -m pepflowww_torch.train --config configs/learn_angle_tpu.yaml \
        --synthetic [--max_iters N] [--val_freq N] [--batch_size N] \
        [--log_freq N] [--logdir ./logs] [--tag T] [--resume CKPT] [--debug] \
        [--device cpu]

Runs on CUDA unless ``--device`` names another device. Batches are
synthetic complexes (``--synthetic``: a 48-residue pocket and a 12-residue
peptide padded to 64), and a synthetic validation split of two batches
drives the plateau scheduler every ``val_freq`` iterations. A checkpoint
``<run>/checkpoints/<it>.pt`` is written every ``val_freq`` iterations and
on SIGTERM (then the run exits); ``--resume`` takes a checkpoint file or a
checkpoint directory (its latest) and continues after its iteration.
``--debug`` logs to the console only: no log file, no metrics file (the run
directory then holds only checkpoints). Reading a dataset and the
multi-device flags come with later slices.
"""

from __future__ import annotations

import argparse
import os
import shutil
import signal
import time

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="configs/learn_angle.yaml")
    ap.add_argument("--logdir", default="./logs")
    ap.add_argument("--tag", default="")
    ap.add_argument("--resume", default=None, help="checkpoint file or checkpoint directory")
    ap.add_argument("--debug", action="store_true")
    ap.add_argument("--synthetic", action="store_true", help="train on synthetic complexes")
    ap.add_argument("--max_iters", type=int, default=None)
    ap.add_argument("--val_freq", type=int, default=None)
    ap.add_argument("--batch_size", type=int, default=None)
    ap.add_argument("--log_freq", type=int, default=100)
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)
    if not args.synthetic:
        ap.error("only --synthetic batches are supported so far")

    from pepflowww_torch.config import load_train_config
    from pepflowww_torch.data.collate import device_batch
    from pepflowww_torch.data.synthetic import make_batch
    from pepflowww_torch.device import resolve_device
    from pepflowww_torch.models.flow import FlowModel, init_weights
    from pepflowww_torch.training import checkpoints
    from pepflowww_torch.training.optim import Optimizer, PlateauScheduler
    from pepflowww_torch.training.train_step import loss_and_total, train_step
    from pepflowww_torch.utils import misc

    dev = resolve_device(args.device)
    model_cfg, cfg, cfg_name = load_train_config(args.config)
    train_cfg = cfg["train"]
    seed = int(train_cfg["seed"])
    misc.seed_all(seed)
    if args.val_freq is not None:
        train_cfg["val_freq"] = args.val_freq
    val_freq = int(train_cfg["val_freq"])
    batch_size = int(args.batch_size or train_cfg["batch_size"])
    max_iters = args.max_iters or int(train_cfg["max_iters"])

    run_dir = misc.get_new_log_dir(args.logdir, prefix=cfg_name, tag=args.tag)
    ckpt_dir = os.path.join(run_dir, "checkpoints")
    if args.debug:
        logger, metrics = misc.get_logger("train"), misc.BlackHole()
    else:
        logger, metrics = misc.get_logger("train", run_dir), misc.MetricsWriter(run_dir)
        shutil.copyfile(args.config, os.path.join(run_dir, os.path.basename(args.config)))

    rng = np.random.default_rng(seed)

    def synthetic(r):
        return device_batch(make_batch(r, batch_size=batch_size, pep_len=12, rec_len=48,
                                       pad_to=64), dev)

    val_rng = np.random.default_rng(seed + 7919)
    val_batches = [synthetic(val_rng) for _ in range(2)]

    model = FlowModel(model_cfg)
    init_weights(model, torch.Generator().manual_seed(seed))
    model = model.to(dev).train()
    logger.info("Device: %s | run dir: %s", dev, run_dir)
    logger.info("Number of parameters: %d", misc.count_parameters(model))

    optimizer = Optimizer(model.parameters(), train_cfg["optimizer"], train_cfg["max_grad_norm"],
                          accum_grad=int(train_cfg.get("accum_grad", 1)))
    sc = train_cfg["scheduler"]
    sched = PlateauScheduler(factor=sc["factor"], patience=sc["patience"], min_lr=sc["min_lr"])
    it_first = 1
    if args.resume:
        it_first = checkpoints.restore_checkpoint(args.resume, model, optimizer, sched) + 1
        logger.info("Resumed from %s at iteration %d", args.resume, it_first)
    loss_weights = dict(train_cfg["loss_weights"])
    generator = torch.Generator(device=dev).manual_seed(seed)

    def validate(it):
        acc = misc.ScalarMetricAccumulator()
        vgen = torch.Generator(device=dev).manual_seed(0)
        with torch.no_grad():
            for vb in val_batches:
                total, losses = loss_and_total(model, vb, loss_weights, vgen)
                bsz = int(vb["aa"].shape[0])
                acc.add("loss", float(total), bsz)
                for name, v in losses.items():
                    acc.add(name, float(v), bsz)
        summary = acc.summary()
        metrics.log(it, summary, tag="val")
        logger.info("val it %d | %s", it, " ".join(f"{k}={v:.4f}" for k, v in summary.items()))
        return summary["loss"]

    stop = {"flag": False}

    def _request_stop(signum, frame):
        stop["flag"] = True
        logger.info("signal %d received; checkpointing and exiting", signum)

    previous = signal.signal(signal.SIGTERM, _request_stop)
    try:
        batch = synthetic(rng)
        t0, seen = time.time(), 0
        for it in range(it_first, max_iters + 1):
            m = train_step(model, optimizer, batch, loss_weights, generator)
            seen += batch_size
            if it % args.log_freq == 0:
                m = {k: float(v) for k, v in m.items()}
                m["samples_per_sec"] = seen / (time.time() - t0)
                m["lr"] = optimizer.lr
                logger.info("it %d | loss %.4f | %s", it, m["loss"],
                            " ".join(f"{k}={v:.4f}" for k, v in m.items() if k.endswith("_loss")))
                metrics.log(it, m, tag="train")
                t0, seen = time.time(), 0
            if it % val_freq == 0:
                model.eval()
                new_lr = sched.step(validate(it), optimizer.lr)
                model.train()
                if new_lr != optimizer.lr:
                    optimizer.lr = new_lr
                    logger.info("lr -> %.3g", new_lr)
            if it % val_freq == 0 or stop["flag"]:
                path = checkpoints.save_checkpoint(ckpt_dir, it, model, optimizer, sched, cfg)
                logger.info("checkpoint -> %s", path)
            if stop["flag"]:
                logger.info("exiting at iteration %d after preemption checkpoint", it)
                break
            batch = synthetic(rng)
    finally:
        signal.signal(signal.SIGTERM, previous)
    return run_dir


if __name__ == "__main__":
    main()
