"""``python -m pepflowww_torch.width_sweep`` on the CPU: widths 1 and 2 at
B = 2, one block, one timed step. Its rows carry exactly the fields of the
JAX package's ``tools/width_sweep.py`` (read from that tool's source), the
MFU is null (the CPU has no tensor-core peak), the file written with
``--out`` equals the printed rows, and the run imports neither JAX, nor the
JAX package, nor the repo-root ``bench.py`` (``sys.modules`` after the run,
in a process started in the repository's root, where ``import bench`` would
find it)."""

import ast
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = """
import json, runpy, sys
sys.argv = ["width_sweep"] + sys.argv[1:]
runpy.run_module("pepflowww_torch.width_sweep", run_name="__main__")
print("MODULES " + json.dumps(sorted(m for m in sys.modules if m in ("bench", "jax")
                                     or m.startswith(("jax.", "pepflowww_tpu")))))
"""


def _jax_row_fields():
    """The keys of the row dict that ``tools/width_sweep.py::run_width``
    returns, in order."""
    tree = ast.parse(open(os.path.join(ROOT, "tools", "width_sweep.py")).read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "run_width")
    ret = next(n for n in ast.walk(fn) if isinstance(n, ast.Return))
    return [k.value for k in ret.value.keys]


def test_width_sweep_cli_on_cpu(tmp_path):
    out = tmp_path / "rows.json"
    res = subprocess.run(
        [sys.executable, "-c", RUN, "--device", "cpu", "--widths", "1,2", "--batch", "2,2",
         "--num_blocks", "1", "--steps", "1", "--out", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": ROOT})
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.strip().splitlines()
    assert lines[0].startswith("device: cpu")
    rows = json.loads(out.read_text())
    assert [json.loads(ln) for ln in lines[1:3]] == rows
    fields = _jax_row_fields()
    assert fields == ["width", "batch", "params", "train_step_ms", "train_samples_per_sec",
                      "train_mfu", "sampler_pps_100step"]
    assert [list(r) for r in rows] == [fields, fields]
    assert [(r["width"], r["batch"]) for r in rows] == [(1, 2), (2, 2)]
    for r in rows:
        assert r["train_mfu"] is None
        assert r["train_step_ms"] > 0 and r["train_samples_per_sec"] > 0
        assert r["sampler_pps_100step"] > 0
    assert rows[1]["params"] > 3 * rows[0]["params"]   # widths scale the matrices
    assert json.loads(lines[-1].removeprefix("MODULES ")) == []
