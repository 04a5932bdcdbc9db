"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled on its own by ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface, and loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds). Libraries go to
``build/repro_torch_kernels/`` at the repo root, named by a hash of the
sources and flags, so an edited source is rebuilt and an unchanged one is
loaded as it is. Nothing is compiled when this module is imported: a kernel is
built at its first use, or by ``build_all`` (all sources in parallel).
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
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNELS = ("flash_attention", "flash_attention_bwd", "cola_fit",
           "decode_attention", "multi_lora")

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc"
        if cand and path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> tuple[Path, Path, subprocess.Popen] | None:
    """Start nvcc for one source unless its library is already built."""
    out = _lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return out, tmp, proc


def _finish(name: str, job: tuple[Path, Path, subprocess.Popen]) -> None:
    out, tmp, proc = job
    log, _ = proc.communicate()
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)   # atomic: a concurrent loader never sees half a file


def build_all(names=KERNELS) -> dict[str, str]:
    """Compile every listed kernel that is not built yet, one nvcc per source,
    all started together. Returns {name: ptxas report} for the ones built."""
    jobs = {n: _start(n) for n in names}
    logs = {}
    for n, job in jobs.items():
        if job is not None:
            _finish(n, job)
            logs[n] = build_log(n)
    return logs


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v``: registers, spills) for the
    current build of one kernel's source."""
    return _lib_path(name).with_suffix(".log").read_text()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(_lib_path(name)))
        _LIBS[name] = lib
    return lib


# -- launch plumbing shared by the wrappers ----------------------------------

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}   # csrc/common.cuh


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_launch(rc: int, kernel: str) -> None:
    """Raise unless the C launcher returned 0 (its cudaGetLastError())."""
    if rc != 0:
        raise RuntimeError(f"{kernel}: launch failed with CUDA error {rc}"
                           + (" (shape or dtype not taken)" if rc == -1 else ""))


def require(cond: bool, kernel: str, what: str) -> None:
    if not cond:
        raise ValueError(f"{kernel}: {what}")


def require_no_grad(kernel: str, *tensors: torch.Tensor) -> None:
    """Raise for a kernel that has no backward when autograd would need one:
    a kernel's output carries no ``grad_fn``, so gradients would stop there
    without a word."""
    require(not (torch.is_grad_enabled()
                 and any(t.requires_grad for t in tensors)), kernel,
            "has no backward: called on inputs that require grad")
