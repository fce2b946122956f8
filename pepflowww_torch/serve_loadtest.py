"""Load test for the port's server: concurrent clients, measured latency and
throughput (counterpart of the JAX package's ``tools/serve_loadtest.py``).

Drives a running server (``python -m pepflowww_torch.serve``) with
``--clients`` concurrent clients, each posting ``--requests`` sequential
/sample requests for the same synthetic pocket+peptide complex. All requests
land in one (length-bucket, num_steps) scheduler group, so the server's
cross-request batching merges them toward its batch cap: this measures the
serving stack end to end (HTTP, scheduler merge, device ODE, full-atom
rebuild, PDB strings), not just the sampler.

Prints one JSON line, and ``main`` returns it as a dict:
    {"requests": N, "errors": E, "peptides": P, "wall_s": W,
     "peptides_per_sec": P/W, "latency_s": {"p50": ..., "p90": ..., "max": ...},
     "num_samples": ..., "num_steps": ..., "clients": ...}

It runs on the host only (the complex is written with numpy and the CPU)
and never initializes CUDA.

    python -m pepflowww_torch.serve --synthetic_weights --port 8307 --warmup 64 &
    python -m pepflowww_torch.serve_loadtest --port 8307 --clients 8 --requests 4 \\
        --num_samples 8 --num_steps 100
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import statistics
import sys
import threading
import time
import urllib.request


def _mk_complex_pdbs(pep_len: int, rec_len: int, seed: int):
    import numpy as np

    from pepflowww_torch.data.collate import mask_select_data
    from pepflowww_torch.data.pdb import save_pdb
    from pepflowww_torch.data.synthetic import make_complex

    item = make_complex(np.random.default_rng(seed), pep_len=pep_len, rec_len=rec_len)
    pep = mask_select_data(item, item["generate_mask"])
    rec = mask_select_data(item, ~item["generate_mask"])
    return save_pdb(pep), save_pdb(rec)


def _post(url: str, obj: dict, timeout: float):
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8300)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--requests", type=int, default=4, help="sequential requests per client")
    ap.add_argument("--num_samples", type=int, default=8)
    ap.add_argument("--num_steps", type=int, default=100)
    ap.add_argument("--pep_len", type=int, default=12)
    ap.add_argument("--rec_len", type=int, default=48)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="per-request timeout (the first request may meet a cold shape)")
    return ap


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    url = f"http://{args.host}:{args.port}/sample"
    pep_pdb, pocket_pdb = _mk_complex_pdbs(args.pep_len, args.rec_len, args.seed)
    req = {"pocket_pdb": pocket_pdb, "peptide_pdb": pep_pdb,
           "num_samples": args.num_samples, "num_steps": args.num_steps}

    # One throwaway request absorbs a first-touch cost (the steady state is
    # what a production pool sees; the server's --warmup makes it a no-op).
    _post(url, req, args.timeout)

    latencies: list = []
    errors = 0
    lock = threading.Lock()

    def client(_i: int):
        nonlocal errors
        for _ in range(args.requests):
            t0 = time.perf_counter()
            try:
                out = _post(url, req, args.timeout)
                if len(out["pdbs"]) != args.num_samples:
                    raise ValueError(f"{len(out['pdbs'])} PDBs, expected {args.num_samples}")
                with lock:
                    latencies.append(time.perf_counter() - t0)
            except Exception as e:  # noqa: BLE001 — count, keep loading
                with lock:
                    errors += 1
                print(f"[loadtest] request failed: {e}", file=sys.stderr)

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(args.clients) as ex:
        list(ex.map(client, range(args.clients)))
    wall = time.perf_counter() - t0

    n_ok = len(latencies)
    peptides = n_ok * args.num_samples
    lat = sorted(latencies) or [float("nan")]
    out = {
        "requests": n_ok + errors,
        "errors": errors,
        "peptides": peptides,
        "wall_s": round(wall, 2),
        "peptides_per_sec": round(peptides / wall, 2) if wall else None,
        "latency_s": {
            "p50": round(statistics.median(lat), 3),
            "p90": round(lat[max(0, int(0.9 * len(lat)) - 1)], 3),
            "max": round(lat[-1], 3),
        },
        "num_samples": args.num_samples,
        "num_steps": args.num_steps,
        "clients": args.clients,
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
