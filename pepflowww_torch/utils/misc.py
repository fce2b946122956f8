"""Logging, run directories, seeding, metric sinks and the commit stamp
for the command-line tools (counterpart of the parts of the JAX package's
``utils/misc.py`` that the train CLI uses)."""

from __future__ import annotations

import json
import logging
import os
import random
import subprocess
import time
from typing import Optional

import numpy as np
import torch


class BlackHole:
    """Null object: absorbs any call and attribute."""

    def __setattr__(self, name, value):
        pass

    def __getattr__(self, name):
        return self

    def __call__(self, *args, **kwargs):
        return self


def get_logger(name: str, log_dir: Optional[str] = None) -> logging.Logger:
    """A logger to the console and, with `log_dir`, to ``<log_dir>/log.txt``;
    handlers of an earlier call under the same name are replaced."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    fmt = logging.Formatter("[%(asctime)s::%(name)s::%(levelname)s] %(message)s")
    sh = logging.StreamHandler()
    sh.setLevel(logging.INFO)
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if log_dir is not None:
        fh = logging.FileHandler(os.path.join(log_dir, "log.txt"))
        fh.setLevel(logging.DEBUG)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


def get_new_log_dir(root: str = "./logs", prefix: str = "", tag: str = "") -> str:
    """Make and return ``<root>/<prefix>_<date>_<tag>``."""
    fn = time.strftime("%Y_%m_%d__%H_%M_%S", time.localtime())
    if prefix:
        fn = f"{prefix}_{fn}"
    if tag:
        fn = f"{fn}_{tag}"
    log_dir = os.path.join(root, fn)
    os.makedirs(log_dir, exist_ok=True)
    return log_dir


def seed_all(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed % (2 ** 32))
    torch.manual_seed(seed)


def count_parameters(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


class MetricsWriter:
    """Scalars as JSON lines in ``<log_dir>/metrics.jsonl`` and, with
    `use_wandb` and the ``wandb`` package installed, mirrored to wandb as
    ``<tag>/<name>``; without the package, JSON lines only."""

    def __init__(self, log_dir: str, use_wandb: bool = False,
                 wandb_kwargs: Optional[dict] = None):
        self._f = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._wandb = None
        if use_wandb:
            try:
                import wandb

                wandb.init(**(wandb_kwargs or {}))
                self._wandb = wandb
            except ImportError:
                self._wandb = None

    def log(self, step: int, scalars: dict, tag: str = "train") -> None:
        rec = {"step": step, "tag": tag, "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._wandb is not None:
            self._wandb.log({f"{tag}/{k}": v for k, v in scalars.items()}, step=step)

    def close(self) -> None:
        self._f.close()


class ScalarMetricAccumulator:
    """Batch-size-weighted running means (validation)."""

    def __init__(self):
        self._sums: dict = {}
        self._counts: dict = {}

    def add(self, name: str, value, batchsize: int = 1) -> None:
        self._sums[name] = self._sums.get(name, 0.0) + float(value) * batchsize
        self._counts[name] = self._counts.get(name, 0.0) + batchsize

    def get_average(self, name: str) -> float:
        return self._sums[name] / max(self._counts[name], 1e-8)

    def summary(self) -> dict:
        return {k: self.get_average(k) for k in self._sums}


def git_version_stamp(repo_dir: str = ".") -> str:
    """The commit checked out at `repo_dir` (``git rev-parse HEAD``), or
    "unknown" outside a git checkout."""
    try:
        return subprocess.check_output(["git", "rev-parse", "HEAD"], cwd=repo_dir,
                                       stderr=subprocess.DEVNULL).decode().strip()
    except (OSError, subprocess.CalledProcessError):
        return "unknown"
