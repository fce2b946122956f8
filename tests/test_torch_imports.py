"""No source of the port imports JAX, flax, optax or the JAX package: each
file of pepflowww_torch/ and chip_smoke.py, checked statically (the run-time
check, on a CPU sampling run: tests/test_torch_entry.py)."""

import ast
import glob
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "pepflowww_tpu")


@pytest.mark.parametrize("path", sorted(
    glob.glob(os.path.join(ROOT, "pepflowww_torch", "**", "*.py"), recursive=True))
    + [os.path.join(ROOT, "chip_smoke.py")])
def test_port_sources_import_no_jax(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path} imports {name}"


def test_dp_modules_load_no_jax():
    """The data-parallel modules, at run time in a fresh interpreter: a
    one-rank gloo group started and ended, a batch split and a rank seed
    drawn, and no JAX module and no JAX-package module in sys.modules."""
    import subprocess
    import sys

    code = (
        "import sys, torch\n"
        "from pepflowww_torch import sample, sampling, serve, train\n"
        "from pepflowww_torch.parallel import dist, dp\n"
        "from pepflowww_torch.training import train_step\n"
        "from pepflowww_torch.utils import misc\n"
        "assert dist.init('cpu') == torch.device('cpu') and dist.world_size() == 1\n"
        "assert dist.broadcast_object('x') == 'x' and not dist.any_flag(False)\n"
        "assert dp.rank_rows(torch.arange(6), 1, 3).tolist() == [2, 3]\n"
        "assert dp.rank_seed(5, 0) == 5 != dp.rank_seed(5, 1)\n"
        "dist.destroy()\n"
        f"print(sorted(k for k in sys.modules if k.split('.')[0] in {FORBIDDEN!r}))\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "RANK", "WORLD_SIZE")}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env={**env, "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]"


def test_fsdp_tp_modules_load_no_jax():
    """The FSDP and pair-row TP modules, at run time in a fresh interpreter:
    a one-rank gloo group with its grid, a sharded optimizer that gathers
    and releases a module's parameters, a batch padded to the model size,
    and no JAX module and no JAX-package module in sys.modules."""
    import subprocess
    import sys

    code = (
        "import sys, torch\n"
        "from pepflowww_torch.parallel import dist, fsdp, tp\n"
        "assert dist.init('cpu') == torch.device('cpu')\n"
        "g = dist.setup_grid(1)\n"
        "assert (g.n_data, g.n_model, g.data_rank, g.model_rank) == (1, 1, 0, 0)\n"
        "m = torch.nn.Linear(3, 2)\n"
        "opt = fsdp.ShardedOptimizer(m.parameters(), {'type': 'adam'})\n"
        "assert opt.numel == 8 and m.weight.numel() == 0\n"
        "with opt.gathered():\n"
        "    assert m.weight.shape == (2, 3)\n"
        "assert m.weight.numel() == 0\n"
        "b = tp.pad_length({'aa': torch.zeros(1, 3, dtype=torch.long)}, 4)\n"
        "assert b['aa'].tolist() == [[0, 0, 0, 21]]\n"
        "dist.destroy()\n"
        f"print(sorted(k for k in sys.modules if k.split('.')[0] in {FORBIDDEN!r}))\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "RANK", "WORLD_SIZE")}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env={**env, "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]"


def test_pp_neighbors_dssp_load_no_jax():
    """The pipeline, neighbour and DSSP modules, at run time in a fresh
    interpreter: a one-rank gloo group with a grid of no pipe axis, the
    pipeline's refusal of one stage, a k-nearest query and a DSSP parse,
    and no JAX module and no JAX-package module in sys.modules."""
    import subprocess
    import sys

    code = (
        "import io, sys, torch\n"
        "from pepflowww_torch.data import dssp\n"
        "from pepflowww_torch.models.flow import FlowModelConfig\n"
        "from pepflowww_torch.ops import neighbors\n"
        "from pepflowww_torch.parallel import dist, pp\n"
        "assert dist.init('cpu') == torch.device('cpu')\n"
        "g = dist.setup_grid(1, 1)\n"
        "assert (g.n_pipe, g.pipe_rank, g.n_minor) == (1, 0, 1)\n"
        "assert pp.check(FlowModelConfig(), 1, 4, 8) == pp.STAGES\n"
        "assert pp.check(FlowModelConfig(), 2, 4, 8) is None\n"
        "dist.destroy()\n"
        "d, i, n = neighbors.knn_points(torch.zeros(1, 1, 3), torch.eye(3)[None], 2)\n"
        "assert i.tolist() == [[[0, 1]]] and n.shape == (1, 1, 2, 3)\n"
        "c = dssp.make_dssp_dict(io.StringIO('  #  RESIDUE AA STRUCTURE\\n    1    1 A M  H\\n'))\n"
        "assert c == {'A': [(1, ' ', 'M', 'H')]}\n"
        f"print(sorted(k for k in sys.modules if k.split('.')[0] in {FORBIDDEN!r}))\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "RANK", "WORLD_SIZE")}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env={**env, "OMP_NUM_THREADS": "1"})
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]"
