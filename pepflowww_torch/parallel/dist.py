"""Process groups for the data-parallel entry points (counterpart of the
JAX package's ``parallel/mesh.py`` and of its train CLI's ``--multihost``
rendezvous).

A rank is one process with one device. :func:`init` takes its ranks from
one of three sources:

* torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``MASTER_ADDR``, ``MASTER_PORT``), also set by :func:`launch`;
* ``--multihost --coordinator_address host:port --num_processes N
  --process_id i``: ``init_method="tcp://host:port"``;
* neither: a single rank in this process. ``--dp`` alone means every
  visible GPU of this host (:func:`local_world`); with more than one the CLI
  spawns one rank per GPU itself (:func:`launch`).

The backend follows the device: NCCL for CUDA ranks, gloo for CPU ranks,
and a rank's device is ``cuda:<local rank>``. Host-side values (the stop
flag, the run directory, the server's groups, sampler outputs bound for
the host) go over a gloo group beside the default one
(:func:`control_group`; the default group itself on CPU ranks), so that
reading them never waits for the device's stream. Without an initialized
group every function here acts as the one rank of a world of one.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import queue
import socket
import time
import traceback
from typing import Optional

import torch
import torch.distributed as tdist

_CONTROL = None   # the gloo group of host values; None: the default group
_GRID = None      # the grid of setup_grid; None: the data axis alone
#: Seconds :func:`launch` waits for its ranks after passing a signal on to them.
LAUNCH_GRACE = 120.0


def is_initialized() -> bool:
    return tdist.is_available() and tdist.is_initialized()


def rank() -> int:
    return tdist.get_rank() if is_initialized() else 0


def world_size() -> int:
    return tdist.get_world_size() if is_initialized() else 1


def backend() -> Optional[str]:
    """The default group's backend ("nccl" or "gloo"); None without a group."""
    return tdist.get_backend() if is_initialized() else None


def is_primary() -> bool:
    """Rank 0: the one that logs, writes files and holds the server."""
    return rank() == 0


def control_group():
    return _CONTROL


def local_world(device=None) -> int:
    """Ranks that ``--dp`` runs on this host: one a visible GPU, one on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def spawn_world(device=None, multihost: bool = False) -> int:
    """Ranks that ``--dp`` spawns from this process: :func:`local_world`
    where no other source names the ranks (no torchrun environment, no
    ``--multihost``), else 0 (this process is one rank)."""
    if multihost or ("RANK" in os.environ and "WORLD_SIZE" in os.environ):
        return 0
    return local_world(device)


def free_port() -> int:
    """A free TCP port on the loopback interface (bound to port 0, then released)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init(device=None, *, coordinator_address: Optional[str] = None,
         num_processes: Optional[int] = None, process_id: Optional[int] = None,
         multihost: bool = False, backend: Optional[str] = None,
         timeout: Optional[datetime.timedelta] = None) -> torch.device:
    """Start this process's rank; returns its device.

    `device` as the entry points take it (``cuda`` by default; raises
    without CUDA): ``cuda`` becomes ``cuda:<local rank>``, an explicit
    index is kept. `backend` defaults to the device's (NCCL or gloo); the
    CLIs never set it. `timeout` bounds every collective (the server's
    ranks wait for requests, so it passes a long one)."""
    from pepflowww_torch.device import resolve_device

    global _CONTROL
    dev = resolve_device(device)
    kw = {} if timeout is None else {"timeout": timeout}
    if multihost and coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator_address needs --num_processes and --process_id")
        world, r = int(num_processes), int(process_id)
        kw["init_method"] = f"tcp://{coordinator_address}"
        local = int(os.environ.get("LOCAL_RANK", r % max(local_world(dev), 1)))
    elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        world, r = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        kw["init_method"] = "env://"
        local = int(os.environ.get("LOCAL_RANK", r))
    elif multihost:
        raise ValueError("--multihost needs --coordinator_address, --num_processes and "
                         "--process_id, or torchrun's environment")
    else:
        world, r, local = 1, 0, 0
        kw["store"] = tdist.HashStore()
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    tdist.init_process_group(backend, world_size=world, rank=r, **kw)
    _CONTROL = None if backend == "gloo" else tdist.new_group(
        backend="gloo", **({} if timeout is None else {"timeout": timeout}))
    return dev


def destroy() -> None:
    global _CONTROL, _GRID
    if is_initialized():
        tdist.destroy_process_group()
    _CONTROL, _GRID = None, None


@dataclasses.dataclass(frozen=True)
class Grid:
    """This rank's place in the (data, model) or (data, pipe) grid and its
    groups. The minor axis is the model axis (pair-row TP) or the pipe axis
    (pipeline stages), never both, as in the JAX package. A group is None
    where its axis spans the world (the default group) or has size 1
    (callers run no collective over an axis of size 1)."""

    n_data: int
    n_model: int
    data_rank: int
    model_rank: int
    data_group: object = None
    model_group: object = None
    n_pipe: int = 1
    pipe_rank: int = 0
    pipe_group: object = None

    @property
    def minor_group(self):
        """The group of the ranks that hold the same rows: the model or the pipe group."""
        return self.pipe_group if self.n_pipe > 1 else self.model_group

    @property
    def n_minor(self) -> int:
        return self.n_model * self.n_pipe


def setup_grid(n_model: int = 1, n_pipe: int = 1) -> Grid:
    """Split the initialized world into ``world // n`` data ranks of `n`
    model ranks (`n_model`) or pipeline stages (`n_pipe`) each, the minor
    axis minor in the rank order (the JAX package's ``make_mesh_2d`` and
    ``make_mesh_pp``); every rank calls it (groups are made collectively).
    Raises SystemExit where `n` does not divide the world size. The groups
    take the default group's backend."""
    global _GRID
    world, r = world_size(), rank()
    n_model, n_pipe = int(n_model), int(n_pipe)
    if n_model > 1 and n_pipe > 1:
        raise ValueError("the model and pipe axes do not compose: one minor axis a grid")
    n, flag = (n_pipe, "--pp") if n_pipe > 1 else (n_model, "--tp")
    if n < 1 or world % n:
        raise SystemExit(f"{flag} {n} must divide the world size {world}")
    n_data = world // n
    data_group = minor_group = None
    if n > 1 and is_initialized():
        for d in range(n_data):
            g = tdist.new_group([d * n + m for m in range(n)])
            if d == r // n:
                minor_group = g
        if n_data > 1:
            for m in range(n):
                g = tdist.new_group([d * n + m for d in range(n_data)])
                if m == r % n:
                    data_group = g
    if n_pipe > 1:
        _GRID = Grid(n_data, 1, r // n, 0, data_group, None, n_pipe, r % n, minor_group)
    else:
        _GRID = Grid(n_data, n_model, r // n, r % n, data_group, minor_group)
    return _GRID


def grid() -> Grid:
    """The grid of :func:`setup_grid`, else every rank a data rank."""
    if _GRID is not None:
        return _GRID
    return Grid(world_size(), 1, rank(), 0)


def hop_on_host() -> bool:
    """Whether a stage hop goes through host buffers: gloo's point-to-point
    calls take CPU tensors (a CUDA tensor's address fails its transport's
    write, which ends the process), so over gloo a hop copies a CUDA tensor
    to the host and back; NCCL's take device tensors."""
    return backend() == "gloo"


def send_state(tensors, dst: int) -> None:
    """Send `tensors` in order to global rank `dst` (a stage hop; blocks
    until the receiver has posted its receives, so both sides of a hop
    post them in one fixed order)."""
    host = hop_on_host()
    for t in tensors:
        t = t.detach().contiguous()
        tdist.send(t.cpu() if host else t, dst)


def recv_state(specs, src: int, device) -> list:
    """Receive tensors of the (shape, dtype) `specs`, in order, on `device`
    from global rank `src`: the counterpart of :func:`send_state`."""
    host = hop_on_host()
    out = []
    for shape, dtype in specs:
        buf = torch.empty(shape, dtype=dtype, device="cpu" if host else device)
        tdist.recv(buf, src)
        out.append(buf.to(device))
    return out


def all_gather_into(out: torch.Tensor, inp: torch.Tensor, group=None) -> None:
    """`out` (size n x `inp`'s) = every rank of `group`'s `inp`, in rank order."""
    tdist.all_gather_into_tensor(out, inp, group=group)


def reduce_scatter_into(out: torch.Tensor, inp: torch.Tensor, group=None) -> None:
    """`out` = this rank's block of the sum over `group` of `inp`."""
    tdist.reduce_scatter_tensor(out, inp, group=group)


def barrier() -> None:
    if is_initialized():
        tdist.barrier(group=_CONTROL)


def broadcast_object(obj, src: int = 0):
    """Rank `src`'s `obj` on every rank (pickled, over the control group)."""
    if not is_initialized():
        return obj
    box = [obj]
    tdist.broadcast_object_list(box, src=src, group=_CONTROL)
    return box[0]


def any_flag(flag: bool) -> bool:
    """Whether `flag` is set on any rank (a MAX over the control group)."""
    if not is_initialized():
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32)
    tdist.all_reduce(t, op=tdist.ReduceOp.MAX, group=_CONTROL)
    return bool(t.item())


def launch(fn, world: int, args: tuple = ()) -> list:
    """Run ``fn(*args)`` in `world` spawned processes, ranks 0 … world-1,
    with torchrun's environment set (a free loopback port), so that
    :func:`init` in `fn` joins them. Returns their results in rank order;
    raises with the traceback of the first rank that failed or died, or
    that exited with a code other than 0, after ending every other.

    SIGTERM and SIGINT sent to this process go on to every live rank, and
    this process goes on waiting for their results, so that a rank's own
    handler decides how to stop (the train CLI checkpoints); ranks still
    alive :data:`LAUNCH_GRACE` seconds after the first such signal are
    ended."""
    import signal
    import threading

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(fn, args, r, world, port, results),
                         daemon=False) for r in range(world)]
    signalled = []   # the time of the first forwarded signal

    def forward(signum, frame):
        signalled.append(time.monotonic())
        for p in procs:
            if p.pid is not None and p.is_alive():
                os.kill(p.pid, signum)

    previous = {}
    if threading.current_thread() is threading.main_thread():
        previous = {s: signal.signal(s, forward) for s in (signal.SIGTERM, signal.SIGINT)}
    out, failure, seen_dead = {}, None, False
    try:
        for p in procs:
            p.start()
        while len(out) < world and failure is None:
            if signalled and time.monotonic() - signalled[0] > LAUNCH_GRACE:
                failure = (f"ranks {sorted(set(range(world)) - set(out))} still ran "
                           f"{LAUNCH_GRACE} s after a signal")
                break
            try:
                r, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                # A rank that ended without a result (any exit code: a result
                # its queue thread failed to send leaves code 0) fails the
                # launch one poll later; its traceback may still be on its way.
                dead = [i for i, p in enumerate(procs) if i not in out and p.exitcode is not None]
                if dead and not seen_dead:
                    seen_dead = True
                elif dead:
                    failure = (f"rank {dead[0]} exited with code {procs[dead[0]].exitcode} "
                               f"without a result")
                continue
            if ok:
                out[r] = value
            else:
                failure = f"rank {r} failed:\n{value}"
    finally:
        for p in procs:
            if failure is not None and p.is_alive():
                p.terminate()
            if p.pid is not None:
                p.join(60)
            if p.is_alive():
                p.kill()
                p.join()
        for s, handler in previous.items():
            signal.signal(s, handler)
    if failure is None:
        failure = next((f"rank {i} exited with code {p.exitcode}"
                        for i, p in enumerate(procs) if p.exitcode != 0), None)
    if failure is not None:
        raise RuntimeError(failure)
    return [out[r] for r in range(world)]


def _rank_main(fn, args, r, world, port, results):
    os.environ.update({"RANK": str(r), "WORLD_SIZE": str(world), "LOCAL_RANK": str(r),
                       "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)})
    try:
        value = fn(*args)
    except BaseException:   # handed to the parent with its traceback
        results.put((r, False, traceback.format_exc()))
        raise
    finally:
        destroy()
    results.put((r, True, value))
