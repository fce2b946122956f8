"""Training CLI on one device: batches of a PepMerge-style dataset or
synthetic ones, the flow-matching objective, clipped Adam with a plateau
scheduler, and checkpoints in the reference layout.

    python -m pepflowww_torch.train --config configs/learn_angle_tpu.yaml \
        --structure_dir Data/PepMerge_new --dataset_dir Data/cache \
        [--dataset_name pep_pocket_train] [--val_dataset_name pep_pocket_val] \
        [--val_structure_dir DIR] [--exclude_names names.txt] \
        [--max_iters N] [--val_freq N] [--batch_size N] [--log_freq N] \
        [--logdir ./logs] [--tag T] [--resume CKPT] [--debug] [--use_wandb] \
        [--profile_dir DIR] [--device cpu]
    python -m pepflowww_torch.train --config ... --synthetic [...]
    python -m pepflowww_torch.train --dp [--dp_manual] ...
    python -m pepflowww_torch.train --fsdp [--tp N] ... | --tp N ...
    python -m pepflowww_torch.train --pp N [--pp_microbatches M] [--fsdp] ...
    torchrun --nproc_per_node N -m pepflowww_torch.train --dp ...
    python -m pepflowww_torch.train --multihost --coordinator_address HOST:PORT \
        --num_processes N --process_id I ...

Runs on CUDA unless ``--device`` names another device.

Data. A structure directory (``<id>/{peptide.pdb,pocket.pdb}``) is
preprocessed once into ``--dataset_dir`` as ``<dataset_name>`` (the cache
reads in both packages), without the ids of ``--exclude_names``, and read
in length-bucketed, shuffled batches (``DataLoader(shuffle=True,
seed=train.seed)``, collated on a background thread). ``--val_dataset_name``
adds a validation split from ``--val_structure_dir`` (default: the
training directory), read in order with its ragged last batch of each
bucket. ``--synthetic`` trains on synthetic complexes (a 48-residue pocket
and a 12-residue peptide padded to 64) with a synthetic validation split of
two batches.

Schedule. With a validation split the plateau scheduler steps on its mean
loss every ``val_freq`` iterations; without one, on the training loss every
``log_freq`` iterations. A checkpoint ``<run>/checkpoints/<it>.pt`` is
written every ``val_freq`` iterations and on SIGTERM (then the run exits);
``--resume`` takes a checkpoint file or a checkpoint directory (its latest)
and continues after its iteration. The run directory holds a copy of the
config, ``commit.txt``, ``log.txt`` and ``metrics.jsonl`` (mirrored to
wandb with ``--use_wandb`` where the package is installed); ``--debug``
logs to the console only (the run directory then holds only checkpoints).
``--profile_dir`` writes a ``torch.profiler`` trace (CPU and CUDA
activity) of iterations first+10 to first+15 to ``DIR/trace.json``.

Data parallelism. ``--dp`` trains one replica a rank (``parallel/dist.py``:
torchrun's environment, ``--multihost`` with its rendezvous flags, or else
one rank a visible GPU, spawned here; NCCL between GPUs, gloo between CPU
processes). ``--batch_size`` is per rank; each rank takes its contiguous
block of every global batch (the loader's ``num_shards``/``shard_index``;
synthetic batches are drawn for the global batch and split). The step
(``train_step``) draws the global batch's corruption from one seed on
every rank, averages the gradients, and reports global losses, so a run
of N ranks follows the single-process run at N times the batch.
``--dp_manual`` is the JAX package's manual step: each rank draws its own
corruption (``dp.rank_seed``) and rescues its own non-finite step. Every
rank validates on the whole split; rank 0 alone writes the run directory
(its path broadcast), the metrics, the checkpoints and the trace. SIGTERM
on any rank checkpoints and stops every rank at the next iteration.

FSDP and pair-row TP. ``--fsdp`` shards the parameters, Adam's moments
and the accumulator over the data ranks (``parallel/fsdp.py``): each rank
keeps a block between steps, gathers the parameters for the step and for
validation, and reduce-scatters the gradients; a checkpoint holds the
single process's layout and resumes at any data size. ``--tp N`` makes a
(data, model) grid of the ranks, N model ranks to a data rank (N must
divide the world size): the ranks of a model group train on the same rows
and split the query rows of the pair tensors (``parallel/tp.py``), with the
model built without its kernels (``tp.plain_profile``, the JAX package's
rule; the log says so). Each implies the data grid, as ``--dp`` does, and
they compose (state over the data ranks, pair rows over the model ranks);
``--batch_size`` is per data rank, and ``--dp_manual`` with either exits.

Pipeline parallelism. ``--pp N`` makes a (data, pipe) grid, N pipeline
stages to a data rank (N must divide the world size and the model's
num_blocks): the stages of a pipe group train on the same rows, stage s
running blocks [s·k, (s+1)·k) of the trunk, k = num_blocks / N, over
``--pp_microbatches`` M microbatches a step in a GPipe schedule
(``parallel/pp.py``; M must divide the batch a data rank), with the model
built without its kernels (``pp.plain_profile``, as the JAX package's
``make_pp_train_step`` does; the log says so). It implies the data grid,
composes with ``--fsdp`` (state over the data ranks) and not with ``--tp``
or ``--dp_manual``. Every rank holds the whole model and validates with the
unpipelined loss; checkpoints hold the single process's layout.
"""

from __future__ import annotations

import argparse
import os
import shutil
import signal
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The JAX package's train CLI's words for --dp_manual with --fsdp or --tp.
DP_MANUAL_GRID = ("--dp_manual is the 1-D data-mesh path (the whole per-device program runs "
                  "inside shard_map); it cannot compose with --fsdp/--tp/--pp, which need GSPMD "
                  "to place collectives inside the step. Those factories fall back to the "
                  "XLA-graph profile on multi-chip meshes instead (parallel/tp.py).")


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="configs/learn_angle.yaml")
    ap.add_argument("--logdir", default="./logs")
    ap.add_argument("--tag", default="")
    ap.add_argument("--resume", default=None, help="checkpoint file or checkpoint directory")
    ap.add_argument("--debug", action="store_true")
    ap.add_argument("--synthetic", action="store_true", help="train on synthetic complexes")
    ap.add_argument("--structure_dir", default=None)
    ap.add_argument("--dataset_dir", default=None)
    ap.add_argument("--dataset_name", default="pep_pocket_train")
    ap.add_argument("--val_dataset_name", default=None,
                    help="validate every val_freq iterations and step the plateau scheduler "
                         "on the validation loss")
    ap.add_argument("--val_structure_dir", default=None,
                    help="structure directory of the validation split (default: "
                         "--structure_dir)")
    ap.add_argument("--exclude_names", default=None,
                    help="file of ids (one a line) left out of the training cache")
    ap.add_argument("--max_iters", type=int, default=None)
    ap.add_argument("--val_freq", type=int, default=None)
    ap.add_argument("--batch_size", type=int, default=None)
    ap.add_argument("--log_freq", type=int, default=100)
    ap.add_argument("--use_wandb", action="store_true")
    ap.add_argument("--profile_dir", default=None,
                    help="write a torch.profiler trace of iterations first+10 to first+15 here")
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--dp", action="store_true",
                    help="data-parallel: one replica a rank, gradients averaged over ranks")
    ap.add_argument("--dp_manual", action="store_true",
                    help="with --dp: each rank draws its own corruption noise and rescues its "
                         "own non-finite step (the JAX package's manual DP step)")
    ap.add_argument("--fsdp", action="store_true",
                    help="data-parallel with the parameters and the optimizer state sharded "
                         "over the data ranks (parallel/fsdp.py); implies the data grid")
    ap.add_argument("--tp", type=int, default=0,
                    help="model-axis size of a (data, model) grid: the pair tensors' query rows "
                         "split over this many ranks (parallel/tp.py), the batch over the rest; "
                         "the model runs without its kernels; composes with --fsdp")
    ap.add_argument("--pp", type=int, default=0,
                    help="pipe-axis size of a (data, pipe) grid: the trunk's block stack splits "
                         "over this many pipeline stages (GPipe microbatching, parallel/pp.py) "
                         "while the batch splits over the rest; num_blocks must be divisible by "
                         "it; the model runs without its kernels; composes with --fsdp")
    ap.add_argument("--pp_microbatches", type=int, default=4,
                    help="microbatches per step under --pp; the fill/drain bubble is "
                         "(pp-1)/(microbatches+pp-1)")
    ap.add_argument("--multihost", action="store_true",
                    help="join ranks of other processes or hosts (implies --dp): torchrun's "
                         "environment, or the three flags below")
    ap.add_argument("--coordinator_address", default=None, help="HOST:PORT of rank 0")
    ap.add_argument("--num_processes", type=int, default=None)
    ap.add_argument("--process_id", type=int, default=None)
    return ap


def main(argv=None):
    """Runs the CLI; returns the run directory."""
    import sys

    argv = sys.argv[1:] if argv is None else list(argv)
    ap = _parser()
    args = ap.parse_args(argv)
    if not args.synthetic and not (args.structure_dir and args.dataset_dir):
        ap.error("give --structure_dir and --dataset_dir, or --synthetic")
    if args.pp and args.tp:
        from pepflowww_torch.parallel import pp

        ap.error(pp.PP_TP)
    if args.dp_manual and (args.fsdp or args.tp or args.pp):
        raise SystemExit(DP_MANUAL_GRID)
    if args.dp_manual and args.multihost:
        raise SystemExit("--dp_manual is single-process; drop it or drop --multihost")
    args.dp = (args.dp or args.dp_manual or args.multihost or args.fsdp or bool(args.tp)
               or bool(args.pp))
    from pepflowww_torch.device import resolve_device
    from pepflowww_torch.parallel import dist

    dev = resolve_device(args.device)
    if not args.dp:
        return _train(args, dev)
    world = dist.spawn_world(args.device, args.multihost)
    if world > 1:
        return dist.launch(main, world, (argv,))[0]
    dev = dist.init(args.device, multihost=args.multihost,
                    coordinator_address=args.coordinator_address,
                    num_processes=args.num_processes, process_id=args.process_id)
    try:
        dist.setup_grid(args.tp or 1, args.pp or 1)
        run_dir = _train(args, dev)
        dist.barrier()
    finally:
        dist.destroy()
    return run_dir


def _train(args, dev: torch.device) -> str:
    """The run of :func:`main` on this rank's device `dev`."""
    from pepflowww_torch.config import load_train_config
    from pepflowww_torch.data.collate import device_batch
    from pepflowww_torch.models.flow import FlowModel, init_weights
    from pepflowww_torch.parallel import dist, dp, fsdp, pp, tp
    from pepflowww_torch.training import checkpoints
    from pepflowww_torch.training.optim import Optimizer, PlateauScheduler
    from pepflowww_torch.training.train_step import loss_and_total, train_step
    from pepflowww_torch.utils import misc

    rank, world, primary = dist.rank(), dist.world_size(), dist.is_primary()
    grid = dist.grid()
    model_cfg, cfg, cfg_name = load_train_config(args.config)
    train_cfg = cfg["train"]
    seed = int(train_cfg["seed"])
    misc.seed_all(seed)
    if args.val_freq is not None:
        train_cfg["val_freq"] = args.val_freq
    val_freq = int(train_cfg["val_freq"])
    batch_size = int(args.batch_size or train_cfg["batch_size"])
    max_iters = args.max_iters or int(train_cfg["max_iters"])
    if args.pp:
        refused = pp.check(model_cfg, args.pp, args.pp_microbatches, batch_size * grid.n_data,
                           grid.n_data)
        if refused is not None:
            raise SystemExit(refused)

    # One run directory, made by rank 0, however many ranks train.
    run_dir = dist.broadcast_object(
        misc.get_new_log_dir(args.logdir, prefix=cfg_name, tag=args.tag) if primary else None)
    ckpt_dir = os.path.join(run_dir, "checkpoints")
    if not primary:
        logger, metrics = misc.BlackHole(), misc.BlackHole()
    elif args.debug:
        logger, metrics = misc.get_logger("train"), misc.BlackHole()
    else:
        logger = misc.get_logger("train", run_dir)
        metrics = misc.MetricsWriter(run_dir, use_wandb=args.use_wandb,
                                     wandb_kwargs={"project": "pepflowww_torch",
                                                   "config": dict(cfg)})
        shutil.copyfile(args.config, os.path.join(run_dir, os.path.basename(args.config)))
        with open(os.path.join(run_dir, "commit.txt"), "w") as f:
            f.write(misc.git_version_stamp(ROOT) + "\n")

    if args.synthetic:
        from pepflowww_torch.data.synthetic import make_batch

        rng = np.random.default_rng(seed)

        def synthetic(r):
            return make_batch(r, batch_size=batch_size * grid.n_data, pep_len=12, rec_len=48,
                              pad_to=64)

        val_rng = np.random.default_rng(seed + 7919)
        val_loader = [synthetic(val_rng) for _ in range(2)]
        train_iter = (dp.rank_rows(synthetic(rng), grid.data_rank, grid.n_data)
                      for _ in iter(int, 1))
        n_train = -1
    else:
        from pepflowww_torch.data.dataset import DataLoader, PepDataset

        dataset = PepDataset(args.structure_dir, args.dataset_dir, name=args.dataset_name,
                             exclude_names_file=args.exclude_names)
        n_train = len(dataset)
        train_iter = DataLoader(dataset, batch_size=batch_size, shuffle=True, seed=seed,
                                num_shards=grid.n_data, shard_index=grid.data_rank).prefetch()
        val_loader = None
        if args.val_dataset_name:
            val_dataset = PepDataset(args.val_structure_dir or args.structure_dir,
                                     args.dataset_dir, name=args.val_dataset_name)
            val_loader = DataLoader(val_dataset, batch_size=batch_size, shuffle=False,
                                    drop_last=False)

    if args.tp:
        model_cfg = tp.plain_profile(model_cfg)
    elif args.pp:
        model_cfg = pp.plain_profile(model_cfg)
    model = FlowModel(model_cfg)
    init_weights(model, torch.Generator().manual_seed(seed))
    model = model.to(dev).train()
    logger.info("Device: %s | world size: %d | backend: %s | train size: %d | run dir: %s",
                dev, world, dist.backend(), n_train, run_dir)
    if (args.fsdp or args.tp) and not args.pp:
        logger.info("grid: %d data x %d model ranks | fsdp: %s | tp: %s", grid.n_data,
                    grid.n_model, bool(args.fsdp),
                    f"pair rows over {grid.n_model} model ranks, kernels off "
                    "(use_pallas, use_pallas_ipa, quant_int8: the plain profile)" if args.tp
                    else "off")
    if args.pp:
        M, nb = args.pp_microbatches, model_cfg.ipa.num_blocks
        logger.info("grid: %d data x %d pipe ranks | fsdp: %s | pp: %d stages of %d blocks, %d "
                    "microbatches of %d rows, bubble %.3f, kernels off (use_pallas, "
                    "use_pallas_ipa, quant_int8: the plain profile)", grid.n_data, grid.n_pipe,
                    bool(args.fsdp), grid.n_pipe, nb // grid.n_pipe, M, batch_size // M,
                    (grid.n_pipe - 1) / (M + grid.n_pipe - 1))
    logger.info("Number of parameters: %d", misc.count_parameters(model))

    opt_cls = fsdp.ShardedOptimizer if args.fsdp else Optimizer
    optimizer = opt_cls(model.parameters(), train_cfg["optimizer"], train_cfg["max_grad_norm"],
                        accum_grad=int(train_cfg.get("accum_grad", 1)))
    sc = train_cfg["scheduler"]
    sched = PlateauScheduler(factor=sc["factor"], patience=sc["patience"], min_lr=sc["min_lr"])
    it_first = 1
    if args.resume:
        it_first = checkpoints.restore_checkpoint(args.resume, model, optimizer, sched) + 1
        logger.info("Resumed from %s at iteration %d", args.resume, it_first)
    loss_weights = dict(train_cfg["loss_weights"])
    # The global step draws the global batch's noise from one seed on every
    # rank; the manual step draws each rank's own.
    generator = dp.rank_generator(seed, rank if args.dp_manual else 0, dev)

    def validate(it):
        """Mean weighted loss over the validation split, in eval mode."""
        acc = misc.ScalarMetricAccumulator()
        vgen = torch.Generator(device=dev).manual_seed(0)
        model.eval()
        with torch.no_grad(), optimizer.gathered():
            for vb in val_loader:
                total, losses = loss_and_total(model, device_batch(vb, dev), loss_weights, vgen)
                bsz = int(vb["aa"].shape[0])
                acc.add("loss", float(total), bsz)
                for name, v in losses.items():
                    acc.add(name, float(v), bsz)
        model.train()
        summary = acc.summary()
        metrics.log(it, summary, tag="val")
        logger.info("val it %d | %s", it, " ".join(f"{k}={v:.4f}" for k, v in summary.items()))
        return summary["loss"]

    def step_scheduler(metric):
        new_lr = sched.step(metric, optimizer.lr)
        if new_lr != optimizer.lr:
            optimizer.lr = new_lr
            logger.info("lr -> %.3g", new_lr)

    # Set by the handler only, never cleared: a signal that lands while the
    # ranks agree on stopping (inside dist.any_flag) is read at the next one.
    requested = {"flag": False}

    def _request_stop(signum, frame):
        requested["flag"] = True
        logger.info("signal %d received; checkpointing and exiting", signum)

    prof = None
    previous = signal.signal(signal.SIGTERM, _request_stop)
    try:
        batch = device_batch(next(train_iter), dev)
        t0, seen = time.time(), 0
        for it in range(it_first, max_iters + 1):
            if args.profile_dir and primary and it == it_first + 10:
                from torch.profiler import ProfilerActivity, profile

                activities = [ProfilerActivity.CPU]
                if dev.type == "cuda":
                    activities.append(ProfilerActivity.CUDA)
                prof = profile(activities=activities)
                prof.start()
            if prof is not None and it == it_first + 15:
                prof = _stop_profile(prof, args.profile_dir, logger)
            m = train_step(model, optimizer, batch, loss_weights, generator,
                           manual=args.dp_manual, n_micro=args.pp_microbatches)
            seen += int(batch["aa"].shape[0]) * grid.n_data
            if it % args.log_freq == 0:
                m = {k: float(v) for k, v in m.items()}
                m["samples_per_sec"] = seen / (time.time() - t0)
                m["lr"] = optimizer.lr
                logger.info("it %d | loss %.4f | %s", it, m["loss"],
                            " ".join(f"{k}={v:.4f}" for k, v in m.items() if k.endswith("_loss")))
                metrics.log(it, m, tag="train")
                if val_loader is None:
                    step_scheduler(m["loss"])
                t0, seen = time.time(), 0
            if val_loader is not None and it % val_freq == 0:
                # Rank 0's value, so that every rank's learning rate moves alike.
                step_scheduler(dist.broadcast_object(validate(it)))
            stop = dist.any_flag(requested["flag"]) if args.dp else requested["flag"]
            if it % val_freq == 0 or stop:
                path = checkpoints.save_checkpoint(ckpt_dir, it, model, optimizer, sched, cfg)
                if path is not None:
                    logger.info("checkpoint -> %s", path)
            if stop:
                logger.info("exiting at iteration %d after preemption checkpoint", it)
                break
            batch = device_batch(next(train_iter), dev)
    finally:
        signal.signal(signal.SIGTERM, previous)
        train_iter.close()
        if prof is not None:
            _stop_profile(prof, args.profile_dir, logger)
        metrics.close()
    return run_dir


def _stop_profile(prof, out_dir: str, logger) -> None:
    """Stop `prof` and write its trace to ``out_dir/trace.json``."""
    prof.stop()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)
    logger.info("profiler trace written to %s", path)
    return None


if __name__ == "__main__":
    main()
