"""Build, load and launch the port's hand-written CUDA kernels.

The sources under ``csrc/`` are compiled at first use by ``nvcc`` for
``sm_90a`` -- one ``nvcc`` per source, all started together -- and linked
into one shared library with a plain C interface, which is loaded with
``ctypes``.  The library lands in ``dspmap_tpu_torch/build/``
(git-ignored) under a name that carries a hash of the sources, so an edited
source is rebuilt and an unchanged one is reused within a checkout.

Every entry point has the same C signature::

    int fn(const uint64_t* ptrs, const float* fparams, const int* iparams,
           cudaStream_t stream);

``ptrs`` holds the device pointers, the two parameter arrays the scalars;
the host function packs them into a by-value kernel argument, launches on
``stream`` and returns ``cudaGetLastError()``.  A nonzero return raises.

``LAUNCHES`` counts the launches of each kernel (one per wrapper call that
reached the kernel); :func:`reset_launch_counts` zeroes it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

_PKG = pathlib.Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
SOURCES = ("occupancy.cu", "sweep.cu", "update.cu", "segscan.cu",
           "relayout.cu", "assignment.cu", "cluster.cu")
ENTRY_POINTS = ("dspmap_occupancy_pool_pass", "dspmap_sweep",
                "dspmap_update_pass1", "dspmap_update_pass2",
                "dspmap_seg_scans", "dspmap_to_flat", "dspmap_from_flat",
                "dspmap_jv_solve", "dspmap_euclidean_cluster")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

LAUNCHES = {"occupancy_pool_pass": 0, "sweep": 0,
            "update_pass1": 0, "update_pass2": 0, "seg_scans": 0,
            "to_flat": 0, "from_flat": 0, "jv_solve": 0,
            "euclidean_cluster": 0}

_lib = None
_lock = threading.Lock()
#: compute capability by device index: asked of the card once, not
#: once a launch
_capability: dict = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES + ("common.cuh",):
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> pathlib.Path:
    """Compile ``csrc/*.cu`` into the build directory (if not already built
    from these exact sources) and return the library's path."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"libdspmap_kernels_{_source_hash()}.so"
    if out.exists():
        return out
    nvcc = _nvcc()
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    objs = [tmp.with_suffix(f".{pathlib.Path(s).stem}.o") for s in SOURCES]
    extra = ["-Xptxas=-v"] if verbose else []
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, *extra, "-c", "-o", str(o),
                               str(CSRC / s)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for s, o in zip(SOURCES, objs)]
    logs = [(s, p.communicate(), p.returncode) for s, p in zip(SOURCES, procs)]
    try:
        for s, (_, err), rc in logs:
            if rc != 0:
                raise RuntimeError(f"nvcc failed on {s} ({rc}):\n{err}")
            if verbose and err:
                print(err)
        res = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                              *map(str, objs)], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{res.stderr}")
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            so = ctypes.CDLL(str(build()))
            for name in ENTRY_POINTS:
                fn = getattr(so, name)
                fn.argtypes = [ctypes.c_void_p] * 4
                fn.restype = ctypes.c_int
            so.dspmap_error_string.argtypes = [ctypes.c_int]
            so.dspmap_error_string.restype = ctypes.c_char_p
            _lib = so
    return _lib


def check_cuda(*tensors: torch.Tensor, shape=None) -> None:
    """Raise unless every tensor lies on one compute-capability-9.x card, is
    contiguous and, where ``shape`` is given, has that shape (the library
    holds ``sm_90a`` code only)."""
    dev = tensors[0].device
    cap = _capability.get(dev.index)
    if cap is None:
        cap = _capability[dev.index] = torch.cuda.get_device_capability(dev)
    major, minor = cap
    if major != 9:
        raise RuntimeError(
            f"the port's kernels are built for sm_90a; {dev} is sm_{major}{minor}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensor on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")
        if shape is not None and tuple(t.shape) != tuple(shape):
            raise ValueError(f"operand of shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")


def launch(name: str, ptrs, fparams=(), iparams=()) -> None:
    """Launch entry point ``dspmap_<name>`` on the current stream and count
    it; raises on a nonzero ``cudaGetLastError()``.  ``ptrs`` holds tensors,
    device addresses as ints, or ``None`` for a null pointer."""
    vals = [0 if x is None else (x.data_ptr() if isinstance(
        x, torch.Tensor) else int(x)) for x in ptrs]
    p = (ctypes.c_uint64 * len(vals))(*vals)
    f = (ctypes.c_float * (len(fparams) + 1))(*fparams)
    i = (ctypes.c_int * (len(iparams) + 1))(*iparams)
    stream = torch.cuda.current_stream().cuda_stream
    so = lib()
    rc = getattr(so, "dspmap_" + name)(
        ctypes.addressof(p), ctypes.addressof(f), ctypes.addressof(i), stream)
    if rc != 0:
        raise RuntimeError(f"dspmap_{name} launch failed: "
                           f"{so.dspmap_error_string(rc).decode()} ({rc})")
    LAUNCHES[name] += 1
