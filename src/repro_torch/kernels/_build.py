"""Build and load the port's hand-written CUDA kernels.

The port's counterpart of the reference's ``kernels/pallas_compat.py``, with
no switch between kernels and plain code in it: a wrapper takes its plain
PyTorch version for a CPU tensor and its kernel for a CUDA tensor, and the
tensor's device alone decides.

Each ``csrc/<name>.cu`` is a plain C interface compiled by ``nvcc`` into
``build/repro_torch_kernels/lib<name>-<hash>.so`` at the repository root
(the hash is of the source, every shared header ``csrc/*.cuh`` and the
compiler flags, so an edit to any of them builds anew) the first time a
kernel of it launches, and is loaded with ``ctypes``.  Nothing is built
when a module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
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


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``.

    signatures: C function name -> ctypes argtypes; every function returns
    the ``cudaError_t`` of its launch as an int.
    """
    lib = _loaded.get(name)
    if lib is None:
        _finish(name, _start(name))
        lib = ctypes.CDLL(str(_lib_path(name)))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _loaded[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise when a launch returned a nonzero ``cudaGetLastError()``."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed (cudaError_t {err})")


def on_cpu(what: str, *xs: torch.Tensor, aligned: bool = True) -> bool:
    """Where a wrapper's operands lie: True when all are CPU tensors (the
    plain version runs), False when all are contiguous tensors on the
    current CUDA device, 16-byte aligned where ``aligned`` says the kernel
    needs it (the kernel launches); raises on anything else, a mix of
    devices first."""
    dev = xs[0].device
    if any(x.device != dev for x in xs):
        devices = sorted({str(x.device) for x in xs})
        raise ValueError(f"{what}: operands on {devices}; all must lie on "
                         f"one device")
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"{what}: operands on {dev}; the kernel takes CUDA "
                         f"tensors and the plain version CPU tensors")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"{what}: operands on {dev}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    if any(not x.is_contiguous() for x in xs):
        raise ValueError(f"{what}: operands must be contiguous")
    if aligned and any(x.data_ptr() % 16 for x in xs):
        raise ValueError(f"{what}: operands must be 16-byte aligned")
    return False


def stream_of(t: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream
