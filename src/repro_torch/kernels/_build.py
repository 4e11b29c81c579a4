"""Build and load the port's hand-written CUDA kernels.

The port's counterpart of the reference's ``kernels/pallas_compat.py``, with
no switch between kernels and plain code in it: a wrapper takes its plain
PyTorch version for a CPU tensor and its kernel for a CUDA tensor, and the
tensor's device alone decides.

Each ``csrc/<name>.cu`` is a plain C interface compiled by ``nvcc`` into
``build/repro_torch_kernels/lib<name>-<hash>.so`` at the repository root
(the hash is of the source, every shared header ``csrc/*.cuh`` and the
compiler flags, so an edit to any of them builds anew) the first time a
kernel of it launches, and is loaded with ``ctypes``; each entry point
takes its arguments packed into one buffer (:func:`bind`).  Nothing is
built when a module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
TOOLKIT_NVCC = "/usr/local/cuda/bin/nvcc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_loaded: dict[str, ctypes.CDLL] = {}
nvcc_runs = 0      # nvcc processes started by this process


def nvcc() -> str:
    """Path of ``nvcc``; raises when the CUDA toolkit is absent."""
    path = shutil.which("nvcc") or TOOLKIT_NVCC
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of repro_torch build only "
            "where the CUDA toolkit is installed")
    return path


def sources() -> list[str]:
    """Names of every kernel source under ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _start(name: str):
    """Start ``nvcc`` for one source; None when its library is built."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    global nvcc_runs
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    nvcc_runs += 1
    return proc, tmp, out


def _finish(name: str, job) -> None:
    if job is None:
        return
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all() -> None:
    """Compile every source under ``csrc/``, all ``nvcc`` runs at once."""
    jobs = {name: _start(name) for name in sources()}
    for name, job in jobs.items():
        _finish(name, job)


def bind(name: str, fn: str, fields: str):
    """The C function ``fn`` of ``csrc/<name>.cu`` (built if needed, and
    loaded), as a callable that takes its arguments in order and returns
    the ``cudaError_t`` of its launch as an int.

    fields: one ``struct`` code an argument, ``q`` for an integer or a
    pointer (a ``data_ptr()``), ``d`` for a float.  The callable packs the
    arguments into one bytes object, the entry point's only parameter
    (``csrc/packed_args.cuh``): ctypes then converts one argument a call,
    where a dozen typed ones cost microseconds of host time.  A wrapper
    binds its kernel once, at its first launch, and keeps the callable at
    module level, so a launch looks nothing up.
    """
    lib = _loaded.get(name)
    if lib is None:
        _finish(name, _start(name))
        lib = ctypes.CDLL(str(_lib_path(name)))
        _loaded[name] = lib
    function = getattr(lib, fn)
    function.argtypes = [ctypes.c_char_p]
    function.restype = ctypes.c_int
    pack = struct.Struct("=" + fields).pack

    def launch(*args) -> int:
        return function(pack(*args))

    return launch


def check(err: int, what: str) -> None:
    """Raise when a launch returned a nonzero ``cudaGetLastError()``."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed (cudaError_t {err})")


def on_cpu(what: str, *xs: torch.Tensor, ids=(),
           aligned: bool = True) -> bool:
    """Where a wrapper's operands lie: True when all are CPU tensors (the
    plain version runs), False when the kernel can take them: every operand
    a contiguous tensor on the current CUDA device, the index operands
    ``ids`` int32, and the data operands ``xs`` 16-byte aligned where
    ``aligned`` says the kernel needs it.  Raises on anything else.

    The kernel's case is one pass of attribute compares, cheap enough for
    the decode path's thousands of launches a step; only a refusal works
    out which rule was broken.  The current device is read on every call:
    ``torch.cuda.set_device`` may change it.
    """
    if xs[0].is_cuda:
        index = torch.cuda.current_device()   # get_device() is -1 off CUDA
        for x in xs:
            if (x.get_device() != index or not x.is_contiguous()
                    or (aligned and x.data_ptr() % 16)):
                break
        else:
            for t in ids:
                if (t.get_device() != index or not t.is_contiguous()
                        or t.dtype != torch.int32):
                    break
            else:
                return False
    elif all(x.device.type == "cpu" for x in (*xs, *ids)):
        return True
    _refuse(what, xs, ids, aligned)


def _refuse(what: str, xs, ids, aligned: bool):
    """Raise the error that names why :func:`on_cpu` refused its operands,
    a mix of devices first."""
    operands = (*xs, *ids)
    devices = sorted({str(x.device) for x in operands})
    if len(devices) > 1:
        raise ValueError(f"{what}: operands on {devices}; all must lie on "
                         f"one device")
    dev = xs[0].device
    if dev.type != "cuda":
        raise ValueError(f"{what}: operands on {dev}; the kernel takes CUDA "
                         f"tensors and the plain version CPU tensors")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"{what}: operands on {dev}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    if any(not x.is_contiguous() for x in operands):
        raise ValueError(f"{what}: operands must be contiguous")
    if any(t.dtype != torch.int32 for t in ids):
        raise ValueError(f"{what}: index operands must be int32, got "
                         f"{[t.dtype for t in ids]}")
    raise ValueError(f"{what}: operands must be 16-byte aligned")


def stream_of(t: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on ``t``'s device, as an int: the
    capturing stream inside ``torch.cuda.graph``.  PyTorch's raw getter
    (the one Triton's launcher calls) builds no ``torch.cuda.Stream``; it
    exists only in CUDA builds of torch, so it is looked up here, on the
    kernel's path, and never at import."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())
