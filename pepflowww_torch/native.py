"""Build, load and count the package's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` holds a plain C entry point (no PyTorch headers),
so ``nvcc`` builds it into a shared library in seconds. The library lands
in ``pepflowww_torch/build/`` under a name that carries the hash of its
source and of the shared headers (``csrc/*.cuh``), so an edited source is
always rebuilt, and is loaded with ``ctypes``. Nothing here runs at import
time: the first kernel call builds (or :func:`build_all` builds every
source at once, one ``nvcc`` each, in parallel).

``LAUNCHES`` counts kernel launches per wrapper; a wrapper calls
:func:`count_launch` where it launches its kernel and nowhere else. Builds,
loads and counts are safe from several threads at once (the server runs
two groups at a time): one lock makes each library build and load once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")
SOURCES = ("edge_transition", "distance_embed", "edge_transition_bwd", "distance_embed_bwd",
           "ipa2", "ipa2_bwd", "edge_transition_int8", "ipa1", "ipa2_wide")
# No --use_fast_math: K6's quantization scale 127/amax is an IEEE division, as in the JAX kernel.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES = {name: 0 for name in SOURCES}
BUILD_LOG: dict = {}
_FUNCS: dict = {}
_SM_COUNT: dict = {}
# Reentrant: function() holds it around build_all(), which takes it too.
_BUILD_LOCK = threading.RLock()
_COUNT_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def count_launch(name: str) -> None:
    """One launch of kernel `name` (a read-modify-write, so under a lock)."""
    with _COUNT_LOCK:
        LAUNCHES[name] += 1


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels are "
                       "built from pepflowww_torch/csrc at first use")


def _lib_path(name: str) -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in [f"{name}.cu"] + sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh")):
        with open(os.path.join(CSRC_DIR, src), "rb") as f:
            h.update(f.read())
    digest = h.hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def build_all(names=SOURCES) -> dict:
    """Compile every missing library, one nvcc per source, all at once.
    Returns {name: seconds}; raises with the compiler's output on failure."""
    with _BUILD_LOCK:
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs = {}
        t0 = time.perf_counter()
        for name in names:
            out = _lib_path(name)
            if os.path.exists(out):
                continue
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True), tmp, out)
        seconds = {}
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            seconds[name] = time.perf_counter() - t0
            BUILD_LOG[name] = log
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
            os.replace(tmp, out)
        return seconds


def build_stamped(names, define) -> dict:
    """Diagnostic builds of csrc/<name>.cu with ``-D<define>`` (one macro
    for all, or a dict of one a name), beside the package's libraries, one
    nvcc per source, all at once. Returns {name: path}; raises with the
    compiler's output on failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    defines = define if isinstance(define, dict) else dict.fromkeys(names, define)
    procs = {}
    for name in names:
        out = os.path.join(BUILD_DIR, f"lib{name}_stamps.so")
        cmd = [_nvcc(), *NVCC_FLAGS, f"-D{defines[name]}", "-o", out,
               os.path.join(CSRC_DIR, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), out)
    paths = {}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc -D{defines[name]} failed for csrc/{name}.cu:\n{log}")
        paths[name] = out
    return paths


def function(lib: str, name: str, argtypes) -> ctypes._CFuncPtr:
    """The C function `name` of csrc/<lib>.cu (building it if needed), with
    its argument types declared and an int (cudaError_t) result."""
    key = (lib, name)
    fn = _FUNCS.get(key)
    if fn is None:
        with _BUILD_LOCK:
            fn = _FUNCS.get(key)
            if fn is None:
                path = _lib_path(lib)
                if not os.path.exists(path):
                    build_all((lib,))
                fn = getattr(ctypes.CDLL(path), name)
                fn.argtypes, fn.restype = argtypes, ctypes.c_int
                _FUNCS[key] = fn
    return fn


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA `device`, read once per device."""
    import torch

    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SM_COUNT[idx]


def check_tensor(t, name: str, shape, dtype, contiguous: bool = True) -> None:
    """Raise unless `t` is a contiguous, 16-byte aligned CUDA tensor of
    `shape` and `dtype`: what the kernels read with vector loads. With
    ``contiguous=False`` any strides pass (a kernel that reads the tensor
    through its strides)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if contiguous and (not t.is_contiguous() or t.data_ptr() % 16):
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def refuse_autograd(name: str, tensors, hint: str = "use the module's autograd Function, "
                    "which runs the backward kernel") -> None:
    """Raise if grad mode is on and one of `tensors` requires grad: a kernel
    wrapper writes into fresh tensors that autograd cannot follow (the
    modules' autograd Functions run the backward kernels; `hint` says what
    to do instead)."""
    import torch

    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} has no autograd: call it under torch.no_grad(), or {hint}")


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")
