"""Peptide-design inference server (counterpart of the JAX package's
``serve.py``).

Loads the FlowModel once, optionally warms every group size a length bucket
can see, and serves full-atom peptide codesign over HTTP.

Endpoints:
    GET  /healthz             -> {"status": "ok", "device": "<torch device> <card>"}
                                 (and "world_size": N under --dp or --tp, and
                                 "tp": {...} under --tp)
    POST /sample              -> generated peptides for one pocket
        request JSON:
            pocket_pdb:   str   PDB text of the receptor pocket
            peptide_pdb:  str   (optional) native peptide PDB; its length and
                                centroid define the generation task. If
                                absent, `peptide_len` must be given and the
                                pocket centroid seeds the placement.
            peptide_len:  int   (optional, default 12)
            num_samples:  int   (default 8)
            num_steps:    int   (default 100)
            seed:         int   (default 0)
        response JSON:
            pdbs: [str]         generated full-atom complexes
            metrics: {ca_rmsd, aar, tm_score}   (vs native peptide if given)
        errors: 400 with {"error": "<Class>: <message>"}

Usage:
    python -m pepflowww_torch.serve --ckpt logs/<run>/checkpoints --port 8300
    python -m pepflowww_torch.serve --synthetic_weights --port 8300 --warmup 64
    python -m pepflowww_torch.serve --synthetic_weights --port 0 --device cpu
    python -m pepflowww_torch.serve --dp ...   (or under torchrun)
    python -m pepflowww_torch.serve --tp N ...

Runs on CUDA unless ``--device`` names another device, and raises without
CUDA. Concurrent requests whose complexes fall in the same (length bucket,
num_steps) group are merged by :class:`BatchScheduler` into one sampler
call of at most 64 rows (a larger request runs as 64-row chunks), padded to
a power of two by replicating the last row. ``--warmup`` drives that path at
every padded size from 1 to 64 rows, so no request meets a cold shape.

``--dp`` serves over the ranks of ``parallel/dist.py`` (one a visible GPU,
or torchrun's): rank 0 holds the HTTP server and the scheduler, whose merge
cap becomes 64 x the world size and whose padded sizes are the world size
times a power of two. One dispatching thread (:class:`Dispatcher`) hands
each group to every rank in one order (collectives from two threads on one
group are not ordered); each rank samples its contiguous block of the rows
in 64-row chunks with its own generator, and rank 0 gathers the outputs
and post-processes them on the host while the next group is dispatched.

``--tp N`` makes a (data, model) grid of those ranks, N model ranks to a
data rank: a group's rows split over the data ranks (the merge cap and the
padded sizes follow their number), and the ranks of each model group
sample their rows together, splitting the pair rows (``parallel/tp.py``;
the model built without its kernels, ``tp.plain_profile``, which the
start-up line and /healthz report).
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import datetime
import json
import os
import signal
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

#: Rows of one sampler call: a larger group runs as sequential chunks.
MICROBATCH = 64
#: Under --dp the other ranks wait for rank 0's next group as long as the server runs.
DP_TIMEOUT = datetime.timedelta(days=365)


class ServeState:
    """What a server holds: the model on its device, the profile's name,
    the scheduler (made by the first request), the group counter that
    seeds each group's generator and, under ``--dp`` or ``--tp``, the
    number of data ranks (``world``: a group's rows split over them), the
    model ranks to a data rank (``tp``, 0 without ``--tp``) and the
    :class:`Dispatcher`."""

    def __init__(self, model, device: torch.device, profile: str):
        self.model, self.device, self.profile = model, device, profile
        self.device_name = str(device)
        if device.type == "cuda":
            self.device_name += " " + torch.cuda.get_device_name(device)
        self.lock = threading.Lock()
        self.scheduler = None
        self.key_counter = 0
        self.world = 1
        self.tp = 0
        self.dispatcher = None


class _Server(ThreadingHTTPServer):
    """socketserver's default listen backlog is 5; a client pool that opens
    its connections simultaneously (the load test at 32 clients) overflows
    that accept queue and gets connection resets before the handler ever
    runs. 128 covers any realistic pool; accepted connections still queue in
    the scheduler, which is where admission control lives."""

    request_queue_size = 128

    def __init__(self, address, state: ServeState):
        self.state = state
        super().__init__(address, Handler)


class BatchScheduler:
    """Cross-request batching: concurrent /sample requests whose complexes
    fall in the same (length-bucket, num_steps) group are padded to the bucket
    and run as one device call, so the card sees B≈max_batch regardless of
    how clients chop their requests.

    Execution is `inflight`-deep (default 2): while one group's results are
    being post-processed on the host (full-atom reconstruction, PDB strings,
    metrics), the next group's device call is already dispatched. Device
    calls themselves serialize on the card's stream."""

    def __init__(self, run_group, max_batch: int = 64, max_wait_ms: float = 25.0,
                 inflight: int = 2):
        self.run_group = run_group
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        self.cv = threading.Condition()
        self.pending = collections.defaultdict(list)  # group_key -> [entry]
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=max(1, inflight))
        threading.Thread(target=self._worker, daemon=True).start()

    def submit(self, group_key, rows, context):
        """Queue `rows` (list of item dicts, all padded to the group's bucket)
        and block until results for this request are ready."""
        entry = self._enqueue(group_key, rows, context)
        entry["event"].wait()
        if entry["error"] is not None:
            raise entry["error"]
        return entry["result"]

    def _enqueue(self, group_key, rows, context) -> dict:
        """Append one request to its group's pending list (the worker takes
        the whole list at once; entries queued under one hold of `cv` merge)."""
        entry = {"rows": rows, "context": context, "event": threading.Event(),
                 "result": None, "error": None}
        with self.cv:
            self.pending[group_key].append(entry)
            self.cv.notify()
        return entry

    def _worker(self):
        while True:
            with self.cv:
                while not self.pending:
                    self.cv.wait()
                # Give other requests a short window to join the batch.
                self.cv.wait(timeout=self.max_wait)
                group_key = max(
                    self.pending, key=lambda k: sum(len(e["rows"]) for e in self.pending[k]))
                entries = self.pending.pop(group_key)
            batch_entries = []
            count = 0
            for e in entries:
                if count + len(e["rows"]) > self.max_batch and batch_entries:
                    with self.cv:  # push overflow back
                        self.pending[group_key].append(e)
                        self.cv.notify()
                    continue
                batch_entries.append(e)
                count += len(e["rows"])
            # Hand off to the inflight pool so the next group can dispatch
            # while this one post-processes on the host. The pool's queue
            # has no bound: under steady arrivals groups wait there, not in
            # `pending`, and merges stay small (ROADMAP.md Queue 2).
            self._pool.submit(self._execute, group_key, batch_entries)

    def _execute(self, group_key, batch_entries):
        try:
            all_rows = [r for e in batch_entries for r in e["rows"]]
            results = self.run_group(group_key, all_rows, [e["context"] for e in batch_entries])
            offset = 0
            for e in batch_entries:
                n = len(e["rows"])
                e["result"] = results[offset: offset + n]
                offset += n
                e["event"].set()
        except Exception as err:  # noqa: BLE001 — propagate per request
            for e in batch_entries:
                e["error"] = err
                e["event"].set()


def _build_item(req: dict) -> dict:
    """The preprocessed item of one request: pocket and native peptide as
    the dataset preprocesses them, or, without a peptide, the pocket
    centred on its CA centroid and an extended-chain placeholder of
    `peptide_len` residues from `seed`."""
    from pepflowww_torch import constants as C
    from pepflowww_torch.data.dataset import _torsions, preprocess_structure
    from pepflowww_torch.data.pdb import parse_pdb
    from pepflowww_torch.data.synthetic import make_complex

    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "pocket.pdb"), "w") as f:
            f.write(req["pocket_pdb"])
        if req.get("peptide_pdb"):
            with open(os.path.join(tmp, "peptide.pdb"), "w") as f:
                f.write(req["peptide_pdb"])
            item = preprocess_structure({"id": "query", "pdb_path": tmp})
            if item is None:
                raise ValueError("failed to parse pocket/peptide PDBs")
            return item

        # No native peptide: an extended-chain placeholder of the requested
        # length at the pocket centroid; it only seeds shapes and masks (the
        # sampler replaces everything in the generated region).
        pocket, _ = parse_pdb(os.path.join(tmp, "pocket.pdb"))
    if pocket is None:
        raise ValueError("failed to parse pocket PDB")
    pep_len = int(req.get("peptide_len", 12))
    synth = make_complex(np.random.default_rng(int(req.get("seed", 0))), pep_len=pep_len,
                         rec_len=1)
    pep_mask = synth["generate_mask"]
    center = pocket["pos_heavyatom"][:, C.BBHeavyAtom.CA].mean(axis=0)
    pocket = dict(pocket)
    pocket["pos_heavyatom"] = pocket["pos_heavyatom"] - center
    pocket["chain_nb"] = pocket["chain_nb"] + 1
    pocket["torsion_angle"], pocket["torsion_angle_mask"] = _torsions(pocket["pos_heavyatom"],
                                                                      pocket["aa"])
    item = {"id": "query", "generate_mask": np.concatenate(
        [np.zeros(len(pocket["aa"]), dtype=bool), np.ones(pep_len, dtype=bool)])}
    for k in pocket:
        if isinstance(pocket[k], np.ndarray):
            item[k] = np.concatenate([pocket[k], synth[k][pep_mask]], axis=0)
        elif isinstance(pocket[k], list):
            item[k] = pocket[k] + [x for x, m in zip(synth[k], pep_mask) if m]
    return item


def _make_group_sampler(steps: int):
    """The one rule by which requests and ``--warmup`` build a group's
    sampler: a callable (model, batch, generator) -> outputs that runs the
    Euler sampler for `steps` steps on sequential chunks of at most
    MICROBATCH rows (the JAX sampler's B=64 microbatch) and concatenates
    them in row order (on a grid with a model axis, each chunk on this
    rank's pair rows: ``sampling.grid_euler_sample``)."""
    from pepflowww_torch.sampling import grid_euler_sample

    def run(model, batch, generator):
        B = batch["aa"].shape[0]
        outs = [grid_euler_sample(model, {k: v[i: i + MICROBATCH] for k, v in batch.items()},
                                  generator, num_steps=steps) for i in range(0, B, MICROBATCH)]
        return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}

    return run


def _pad_rule(n_real: int, n_dev: int) -> int:
    """Padded device-batch size for a merged group of `n_real` rows: n_dev x
    (power of two). Extra rows replicate the last item and are discarded
    from the results. The rule is idempotent for every n_dev, pad(pad(n)) ==
    pad(n), which `warmup_sizes` relies on."""
    per_dev = 1
    while per_dev * n_dev < n_real:
        per_dev *= 2
    return per_dev * n_dev


def _group_pad_size(n_real: int, n_dev: int = 1) -> int:
    return _pad_rule(n_real, n_dev)


def warmup_sizes(n_dev: int = 1, cap_per_dev: int = MICROBATCH) -> list:
    """Every padded group size the scheduler can produce over `n_dev`
    ranks: the image of `_pad_rule` over real group sizes from 1 to the
    merge cap, ``cap_per_dev * n_dev``. The JAX server starts its ladder at
    8 rows, which leaves requests of fewer samples cold; this one starts
    at 1."""
    return sorted({_group_pad_size(n, n_dev) for n in range(1, cap_per_dev * n_dev + 1)})


def _sample_rows(model, device: torch.device, group: tuple):
    """One rank's part of a group (bucket, steps, padded rows, seed): its
    contiguous block of the rows through the group sampler, with its own
    generator (without a process group, every row with the seed's).
    Returns (every rank's outputs on rank 0's host, in row order, or None
    on the other ranks; this rank's kernel launches during its sampling)."""
    from pepflowww_torch import native
    from pepflowww_torch.data.collate import device_batch, pad_and_collate
    from pepflowww_torch.parallel import dist, dp

    bucket, steps, rows, seed = group
    g = dist.grid()
    batch = device_batch(pad_and_collate(dp.rank_rows(rows, g.data_rank, g.n_data),
                                         pad_to=bucket), device)
    before = dict(native.LAUNCHES)
    out = _make_group_sampler(steps)(model, batch, dp.rank_generator(seed, g.data_rank, device))
    # .cpu() waits for the card, so the server's split of a group's time is
    # honest; the rebuild then runs on the host, beside the next group's
    # device work.
    out = {k: v.cpu() for k, v in out.items()}
    launched = {k: v - before[k] for k, v in native.LAUNCHES.items() if v != before[k]}
    return dp.gather_rows(out), launched


class Dispatcher:
    """Rank 0's side of ``--dp`` serving: one thread sends every group to
    the other ranks (:func:`_rank_loop`) by a broadcast, samples rank 0's
    rows and gathers the outputs, so that groups reach the ranks in one
    order whatever thread submits them. While it runs, kernel launches on
    rank 0 are this group's alone."""

    def __init__(self, model, device: torch.device):
        self.model, self.device = model, device
        self._thread = concurrent.futures.ThreadPoolExecutor(max_workers=1)

    def run(self, group: tuple):
        """:func:`_sample_rows`'s result for `group`, on rank 0."""
        return self._thread.submit(self._run, group).result()

    def _run(self, group):
        from pepflowww_torch.parallel import dist

        dist.broadcast_object(group)
        return _sample_rows(self.model, self.device, group)

    def close(self) -> None:
        """Release the other ranks (their loops end) and the thread."""
        from pepflowww_torch.parallel import dist

        self._thread.submit(dist.broadcast_object, None).result()
        self._thread.shutdown()


def _rank_loop(model, device: torch.device) -> None:
    """A rank other than 0 under ``--dp``: sample its rows of every group
    rank 0 sends, until rank 0 sends None. It ignores SIGTERM and SIGINT
    (torchrun and ``dist.launch`` send them to every rank): rank 0 stops
    on them and then releases it."""
    from pepflowww_torch.parallel import dist

    for s in (signal.SIGTERM, signal.SIGINT):
        signal.signal(s, signal.SIG_IGN)
    while (group := dist.broadcast_object(None)) is not None:
        _sample_rows(model, device, group)


def _run_group(state: ServeState, group_key, rows, contexts) -> list:
    """Execute one merged device batch; returns one result dict per row."""
    from pepflowww_torch import metrics as M
    from pepflowww_torch.data.collate import pad_and_collate
    from pepflowww_torch.data.pdb import save_pdb
    from pepflowww_torch.inference import _chain_letters, reconstruct_full_atom_outputs

    bucket, steps = group_key
    n_real = len(rows)
    n_padded = _group_pad_size(n_real, state.world)
    rows = rows + [rows[-1]] * (n_padded - n_real)
    batch_np = pad_and_collate(rows, pad_to=bucket)
    with state.lock:
        state.key_counter += 1
        seed = state.key_counter

    t0 = time.perf_counter()
    group = (bucket, steps, rows, seed)
    if state.dispatcher is not None:
        out, launched = state.dispatcher.run(group)
        ranks = f" ranks={state.world * max(state.tp, 1)} rank0_launches={json.dumps(launched)}"
    else:
        out, ranks = _sample_rows(state.model, state.device, group)[0], ""
    t1 = time.perf_counter()
    m = M.evaluate_sample(out, batch_np)
    t2 = time.perf_counter()
    pos15, mask15 = reconstruct_full_atom_outputs(out, batch_np)
    t3 = time.perf_counter()
    seqs = out["seqs"].numpy()
    res_mask = np.asarray(batch_np["res_mask"]).astype(bool)
    chain_nb, resseq = np.asarray(batch_np["chain_nb"]), np.asarray(batch_np["resseq"])
    results = []
    for b in range(n_real):
        sel = res_mask[b]
        pdb = save_pdb({
            "aa": seqs[b][sel],
            "pos_heavyatom": pos15[b][sel],
            "mask_heavyatom": mask15[b][sel],
            "chain_nb": chain_nb[b][sel],
            "resseq": resseq[b][sel],
            "chain_id": _chain_letters(chain_nb[b][sel]),
            "icode": [" "] * int(sel.sum()),
        })
        results.append({
            "pdb": pdb,
            "ca_rmsd": float(m["ca_rmsd"][b]),
            "aar": float(m["aar"][b]),
            "tm_score": float(m["tm_score"][b]),
        })
    t4 = time.perf_counter()
    print(f"[serve] group bucket={bucket} n={n_real}/{n_padded} steps={steps} "
          f"sample={t1 - t0:.2f}s metrics={t2 - t1:.2f}s rebuild={t3 - t2:.2f}s "
          f"pdb={t4 - t3:.2f}s{ranks}", flush=True)
    return results


def _sample(state: ServeState, req: dict) -> dict:
    from pepflowww_torch.data.collate import bucket_length, replicate_item

    item = _build_item(req)
    n = int(req.get("num_samples", 8))
    steps = int(req.get("num_steps", 100))
    bucket = bucket_length(len(item["aa"]))

    with state.lock:
        # Under the lock: two concurrent first requests must not each build
        # a scheduler (the loser's worker would split the batching).
        if state.scheduler is None:
            state.scheduler = BatchScheduler(
                lambda key, rows, contexts: _run_group(state, key, rows, contexts),
                max_batch=MICROBATCH * state.world)
    per_row = state.scheduler.submit((bucket, steps), replicate_item(item, n), req)
    return {
        "pdbs": [r["pdb"] for r in per_row],
        "metrics": {
            "ca_rmsd": [r["ca_rmsd"] for r in per_row],
            "aar": [r["aar"] for r in per_row],
            "tm_score": [r["tm_score"] for r in per_row],
        },
    }


class Handler(BaseHTTPRequestHandler):
    def _json(self, code: int, obj: dict):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/healthz":
            state = self.server.state
            health = {"status": "ok", "device": state.device_name}
            if state.dispatcher is not None:
                health["world_size"] = state.world * max(state.tp, 1)
            if state.tp:
                health["tp"] = {"model_ranks": state.tp, "data_ranks": state.world,
                                "profile": state.profile,
                                "kernels": "off: pair-row TP runs the plain profile"}
            self._json(200, health)
        else:
            self._json(404, {"error": "unknown path"})

    def do_POST(self):
        if self.path != "/sample":
            self._json(404, {"error": "unknown path"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(length))
            self._json(200, _sample(self.server.state, req))
        except Exception as e:  # noqa: BLE001 — server boundary
            self._json(400, {"error": f"{e.__class__.__name__}: {e}"})

    def log_message(self, fmt, *args):
        print("[serve]", fmt % args, flush=True)


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default="configs/learn_angle_tpu.yaml")
    ap.add_argument("--ckpt", "--torch_ckpt", dest="ckpt", default=None,
                    help="a .pt checkpoint (the reference's or pepflowww_torch.train's), or "
                         "a directory of the train CLI's checkpoints (its latest)")
    ap.add_argument("--synthetic_weights", action="store_true",
                    help="weights from --seed (no checkpoint)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--port", type=int, default=8300, help="0: any free port")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--warmup", default=None,
                    help="comma-separated length buckets (e.g. '64,96') to drive at every "
                         "group size from 1 to 64 rows, 100 steps, before serving")
    ap.add_argument("--device", default=None, help="default: cuda")
    ap.add_argument("--dp", action="store_true",
                    help="serve data-parallel over the ranks (one a visible GPU): merged "
                         "groups split over them, the merge cap 64 x the world size")
    ap.add_argument("--tp", type=int, default=0,
                    help="model-axis size of a (data, model) grid of the ranks: the pair "
                         "tensors' query rows split over this many, the rows over the rest; the "
                         "model runs without its kernels")
    return ap


def _profile(cfg) -> str:
    ipa = cfg.ipa
    if ipa.quant_int8:
        return "int8"
    if ipa.use_pallas_ipa:
        return "fused IPA"
    return "production" if ipa.use_pallas else "plain"


def _load_model(args, dev: torch.device):
    """The model of ``--config`` on `dev`, weights from ``--ckpt`` or ``--seed``."""
    from pepflowww_torch.config import load_config
    from pepflowww_torch.convert import read_torch_checkpoint
    from pepflowww_torch.models.flow import build_model
    from pepflowww_torch.training.checkpoints import latest_checkpoint

    sd = None
    if args.ckpt:
        path = latest_checkpoint(args.ckpt) if os.path.isdir(args.ckpt) else args.ckpt
        if path is None:
            raise FileNotFoundError(f"no checkpoint in {args.ckpt}")
        sd = read_torch_checkpoint(path)
    elif not args.synthetic_weights:
        print("[serve] WARNING: no checkpoint given; serving random weights", flush=True)
    cfg = load_config(args.config)
    if args.tp:
        from pepflowww_torch.parallel import tp

        cfg = tp.plain_profile(cfg)
    return build_model(cfg, dev, state_dict=sd, seed=args.seed)


def start(args, model=None, device=None, dispatcher=None) -> ServeState:
    """The server's state from parsed flags: the device (`device`, else
    ``--device``), the model of ``--config`` (or `model`, already on that
    device), under ``--dp`` the `dispatcher` to the ranks of the
    initialized process group and, with ``--warmup``, every ladder size of
    each bucket driven once through :func:`_run_group`, its seconds
    printed."""
    from pepflowww_torch.device import resolve_device
    from pepflowww_torch.parallel import dist

    dev = device if device is not None else resolve_device(args.device)
    if model is None:
        model = _load_model(args, dev)
    state = ServeState(model, dev, _profile(model.cfg))
    if dispatcher is not None:
        g = dist.grid()
        state.world, state.dispatcher = g.n_data, dispatcher
        state.tp = g.n_model if args.tp else 0
        pair = (f", pair rows over {g.n_model} model ranks a data rank (pair-row TP: the plain "
                f"profile, kernels off)" if state.tp else "")
        print(f"[serve] {state.profile} profile on {state.device_name}, data-parallel over "
              f"{state.world} ranks{pair}", flush=True)
    else:
        print(f"[serve] {state.profile} profile on {state.device_name}", flush=True)

    if args.warmup:
        from pepflowww_torch.data.collate import replicate_item
        from pepflowww_torch.data.synthetic import make_complex

        rng = np.random.default_rng(0)
        for bucket in (int(b) for b in args.warmup.split(",")):
            item = make_complex(rng, pep_len=8, rec_len=max(bucket - 24, 8))
            for n in warmup_sizes(state.world):
                t0 = time.perf_counter()
                _run_group(state, (bucket, 100), replicate_item(item, n), [None])
                print(f"[serve] warmed bucket {bucket} n={n} (100 steps, "
                      f"{time.perf_counter() - t0:.2f}s)", flush=True)
    return state


def main(argv=None):
    import sys

    from pepflowww_torch.device import resolve_device
    from pepflowww_torch.parallel import dist

    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parser().parse_args(argv)
    if not (args.dp or args.tp):
        _serve(args, start(args))
        return
    resolve_device(args.device)
    world = dist.spawn_world(args.device)
    if world > 1:
        dist.launch(main, world, (argv,))
        return
    dev = dist.init(args.device, timeout=DP_TIMEOUT)
    try:
        dist.setup_grid(args.tp or 1)
        model = _load_model(args, dev)
        if not dist.is_primary():
            _rank_loop(model, dev)
            return
        dispatcher = Dispatcher(model, dev)
        # SIGTERM ends serve_forever through the finally below, which
        # releases the other ranks.
        signal.signal(signal.SIGTERM, _raise_interrupt)
        try:
            _serve(args, start(args, model, dev, dispatcher))
        except KeyboardInterrupt:
            print("[serve] stopping", flush=True)
        finally:
            dispatcher.close()
    finally:
        dist.destroy()


def _raise_interrupt(signum, frame):
    signal.signal(signal.SIGTERM, signal.SIG_DFL)   # a second SIGTERM ends the process
    raise KeyboardInterrupt


def _serve(args, state: ServeState) -> None:
    server = _Server((args.host, args.port), state)
    host, port = server.server_address[:2]
    print(f"[serve] listening on http://{host}:{port}", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
