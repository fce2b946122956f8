"""Sampling CLI: generate peptides for each complex, write one PDB per
sample, the per-sample metrics (``outputs.csv``) and their aggregate
(``summary.json``).

    python -m pepflowww_torch.sample --config configs/learn_angle_tpu.yaml \
        --structure_dir Data/PepMerge_new --dataset_dir Data/cache \
        [--dataset_name pep_pocket_test] --out results/ --num_samples 64 \
        [--num_steps 100] [--ckpt logs/<run>/checkpoints] [--device cpu]
    python -m pepflowww_torch.sample --synthetic --out results/ [--ckpt model1.pt]
    python -m pepflowww_torch.sample --dp ...   (or under torchrun)
    python -m pepflowww_torch.sample --tp N ...

Complexes come from a PepMerge-style directory (``<id>/{peptide.pdb,
pocket.pdb}``), preprocessed once into ``--dataset_dir`` (the cache reads in
both packages), or are synthetic (``--synthetic``). Weights come from
``--ckpt`` (also spelled ``--torch_ckpt``): a ``.pt`` file, the reference's
or one of ``python -m pepflowww_torch.train``, or a directory of the
latter and its latest; else from ``--seed``. ``--sample_bb/--sample_ang/--sample_seq 0`` keep that
modality at the data. Runs on CUDA unless ``--device`` names another device.

For each complex: ``num_samples`` copies padded to its length bucket, one
Euler sampler run, the metrics on the host, and ``<out>/<id>/sample_<i>.pdb``.
``outputs.csv`` has the columns id, sample, ca_rmsd, ca_rmsd_aligned, aar,
tm_score.

``--dp`` samples each complex's rows over the ranks of
``parallel/dist.py`` (one a visible GPU, or torchrun's), each rank its
contiguous block with its own generator (``sampling.dp_euler_sample``); a
``num_samples`` the world size does not divide is padded with copies of
the last row, which are dropped. Rank 0 gathers the outputs and alone
scores them and writes the PDBs, ``outputs.csv`` and ``summary.json``.
``--tp N`` makes a (data, model) grid of the ranks, N model ranks to a data
rank: each data rank's model group samples its rows together, with one
generator (``dp.rank_seed(seed, data rank)``), splitting the pair rows
(``parallel/tp.py``; the model built without its kernels,
``tp.plain_profile``), so at one data rank it draws what one process draws.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import time

import numpy as np
import torch

CSV_COLUMNS = ("id", "sample", "ca_rmsd", "ca_rmsd_aligned", "aar", "tm_score")


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="configs/learn_angle_tpu.yaml")
    ap.add_argument("--ckpt", "--torch_ckpt", dest="ckpt", default=None,
                    help="a .pt checkpoint (the reference's or pepflowww_torch.train's), or "
                         "a directory of the train CLI's checkpoints (its latest)")
    ap.add_argument("--out", default="./results")
    ap.add_argument("--num_samples", type=int, default=16)
    ap.add_argument("--num_steps", type=int, default=100)
    ap.add_argument("--seed", type=int, default=114514)
    ap.add_argument("--sample_bb", type=int, default=1)
    ap.add_argument("--sample_ang", type=int, default=1)
    ap.add_argument("--sample_seq", type=int, default=1)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--structure_dir", default=None)
    ap.add_argument("--dataset_dir", default=None)
    ap.add_argument("--dataset_name", default="pep_pocket_test")
    ap.add_argument("--max_complexes", type=int, default=None, help="default: all")
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--dp", action="store_true",
                    help="shard each complex's samples over the ranks (one a visible GPU)")
    ap.add_argument("--tp", type=int, default=0,
                    help="model-axis size of a (data, model) grid: the pair tensors' query rows "
                         "split over this many ranks, the samples over the rest; the model runs "
                         "without its kernels")
    return ap


def main(argv=None) -> dict:
    """Runs the CLI; returns {"rows", "summary", "runs"}, ``runs`` one
    {id, L, seconds, peptides_per_s, post_seconds} per complex: the
    sampler's time, and the host's for the metrics and the PDBs (None on
    a rank other than 0)."""
    import sys

    from pepflowww_torch.device import resolve_device
    from pepflowww_torch.parallel import dist

    argv = sys.argv[1:] if argv is None else list(argv)
    ap = _parser()
    args = ap.parse_args(argv)
    if not args.synthetic and not (args.structure_dir and args.dataset_dir):
        ap.error("give --structure_dir and --dataset_dir, or --synthetic")
    dev = resolve_device(args.device)
    if not (args.dp or args.tp):
        return _sample(args, dev)
    world = dist.spawn_world(args.device)
    if world > 1:
        return dist.launch(main, world, (argv,))[0]
    dev = dist.init(args.device)
    try:
        dist.setup_grid(args.tp or 1)
        out = _sample(args, dev)
        dist.barrier()
    finally:
        dist.destroy()
    return out


def _sample(args, dev: torch.device):
    """The run of :func:`main` on this rank's device `dev`."""

    from pepflowww_torch import metrics as M
    from pepflowww_torch.config import load_config
    from pepflowww_torch.convert import read_torch_checkpoint
    from pepflowww_torch.data.collate import device_batch, pad_and_collate, replicate_item
    from pepflowww_torch.inference import write_sample_pdbs
    from pepflowww_torch.models.flow import build_model
    from pepflowww_torch.parallel import dist, dp, tp
    from pepflowww_torch.sampling import dp_euler_sample, euler_sample
    from pepflowww_torch.training.checkpoints import latest_checkpoint

    cfg = load_config(args.config)
    primary = dist.is_primary()

    if args.synthetic:
        from pepflowww_torch.data.synthetic import make_complex

        rng = np.random.default_rng(args.seed)
        items = [make_complex(rng, pep_len=12, rec_len=48, complex_id=f"synth{i}")
                 for i in range(args.max_complexes or 4)]
    else:
        from pepflowww_torch.data.dataset import PepDataset

        ds = PepDataset(args.structure_dir, args.dataset_dir, name=args.dataset_name)
        n = len(ds) if args.max_complexes is None else min(len(ds), args.max_complexes)
        items = [ds[i] for i in range(n)]
        if primary:
            print(f"dataset {args.dataset_name}: {len(ds)} complexes, sampling {n}")

    sd = None
    if args.ckpt:
        path = latest_checkpoint(args.ckpt) if os.path.isdir(args.ckpt) else args.ckpt
        if path is None:
            raise FileNotFoundError(f"no checkpoint in {args.ckpt}")
        sd = read_torch_checkpoint(path)
    if args.tp:
        cfg = tp.plain_profile(cfg)
        if primary:
            g = dist.grid()
            print(f"grid: {g.n_data} data x {g.n_model} model ranks; pair rows over "
                  f"{g.n_model} model ranks, the plain profile (kernels off)")
    model = build_model(cfg, dev, state_dict=sd, seed=args.seed)
    gen = dp.rank_generator(args.seed, dist.grid().data_rank, dev)
    sampler = dp_euler_sample if (args.dp or args.tp) else euler_sample

    if primary:
        os.makedirs(args.out, exist_ok=True)
    rows, runs = [], []
    for item in items:
        batch_np = pad_and_collate(replicate_item(item, args.num_samples))
        batch = device_batch(batch_np, dev)
        L = int(batch["aa"].shape[1])
        t0 = time.perf_counter()
        out = sampler(model, batch, gen, num_steps=args.num_steps,
                      sample_bb=bool(args.sample_bb), sample_ang=bool(args.sample_ang),
                      sample_seq=bool(args.sample_seq))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        sec = time.perf_counter() - t0
        if not primary:
            continue
        t0 = time.perf_counter()
        m = M.evaluate_sample(out, batch_np)
        for s in range(args.num_samples):
            rows.append({"id": item["id"], "sample": s,
                         **{k: float(m[k][s]) for k in CSV_COLUMNS[2:]}})
        paths = write_sample_pdbs(out, batch_np, os.path.join(args.out, item["id"]))
        post = time.perf_counter() - t0
        runs.append({"id": item["id"], "L": L, "seconds": sec,
                     "peptides_per_s": args.num_samples / sec, "post_seconds": post})
        print(f"{item['id']}: {len(paths)} pdbs, L={L}, rmsd={m['ca_rmsd'].mean():.2f} "
              f"aar={m['aar'].mean():.3f}, {sec:.2f} s ({args.num_samples / sec:.2f} "
              f"peptides/s on {dev}); metrics and PDBs {post:.2f} s")

    if not primary:
        return None
    csv_path = os.path.join(args.out, "outputs.csv")
    with open(csv_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(CSV_COLUMNS))
        w.writeheader()
        w.writerows(rows)
    print(f"wrote {len(rows)} rows to {csv_path}")
    summary = M.summarize_outputs(rows)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print("summary: " + " ".join(f"{k}={v:.3f}" if isinstance(v, float) else f"{k}={v}"
                                 for k, v in sorted(summary["overall"].items())))
    return {"rows": rows, "summary": summary, "runs": runs}


if __name__ == "__main__":
    main()
