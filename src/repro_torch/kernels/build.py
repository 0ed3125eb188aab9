"""Build and load the port's CUDA kernels (``csrc/*.cu``) with ``nvcc``,
and the checks every kernel wrapper makes before a launch.

Each source is compiled on first use into a shared library with a plain C
interface under ``build/repro_torch_kernels/`` at the repository root,
named by a hash of its source, so an edited source is rebuilt and an
unchanged one is loaded as it is. Python binds it with ``ctypes``. Nothing
here runs at import: a missing ``nvcc`` or a failed build raises when a
kernel is first launched.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under /usr/local/cuda/bin): "
        "the CUDA kernels of repro_torch are compiled at first use")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to (keyed on the source's hash)."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` for sm_90a unless already built; returns
    the library's path. The compiler's output (``-Xptxas -v``: registers,
    shared memory, spills per kernel) is kept beside it as ``.log``."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-Xptxas", "-v",
           "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = (f"$ {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
           f"seconds: {time.perf_counter() - t0:.2f}\n")
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed building {name}.cu:\n{log}")
    os.replace(tmp, out)
    return out


def build_all(names) -> dict:
    """``build`` every name at once, one ``nvcc`` process each; returns
    ``{name: library path}``."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        return dict(zip(names, pool.map(build, names)))


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``'s library, once per
    process."""
    return ctypes.CDLL(str(build(name)))


def on_cpu(*tensors) -> bool:
    """True if every tensor is on the CPU (the wrapper takes the plain twin),
    False if every one is on one CUDA device (it launches the kernel);
    raises on a mix or on any other device."""
    if all(t.is_cuda for t in tensors):
        if len({t.get_device() for t in tensors}) == 1:
            return False
    elif all(t.device.type == "cpu" for t in tensors):
        return True
    raise ValueError(f"kernels take tensors on one CUDA device or all on "
                     f"the CPU, got {sorted(str(t.device) for t in tensors)}")


def stream(index: int | None = None) -> int:
    """The current CUDA stream's handle, for a kernel's launch: of device
    ``index`` (the cheaper call, without a ``Stream`` object), else of the
    current device."""
    if index is None:
        return torch.cuda.current_stream().cuda_stream
    return torch._C._cuda_getCurrentRawStream(index)
