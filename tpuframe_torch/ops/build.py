"""Build the port's CUDA kernels with ``nvcc`` at first use, and load them.

Each kernel is one source, ``tpuframe_torch/csrc/<name>.cu``, with a plain
C interface.  It compiles for Hopper (``sm_90a``) into a shared library
under ``build/tpuframe_torch/`` beside the package, named by a hash of the
source and the flags: an edited source rebuilds, an unchanged one loads the
library already built.  The library is loaded with :mod:`ctypes`.

Without ``nvcc``, or when a build fails, these functions raise.  There is
no fallback: a CUDA tensor either reaches its kernel or the call fails.

:func:`launch_floor` launches ``csrc/launch_floor.cu``, a kernel that does
nothing, by the same route as every kernel: its time is the least that any
of them can take (``chip_smoke.py`` times it).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

__all__ = ["BUILD_DIR", "KERNELS", "NVCC_FLAGS", "build", "find_nvcc", "launch_floor",
           "library_path", "load"]

#: every kernel source of the port, by name (``csrc/<name>.cu``); ``launch_floor``
#: is the empty kernel that times a launch
KERNELS = ("blockwise_attention", "cross_entropy", "fused_adamw", "launch_floor", "layer_norm",
           "normalize", "quant_wire")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills into the build log
)

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "tpuframe_torch"

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``$CUDA_HOME`` (default
    ``/usr/local/cuda``).  Raises RuntimeError when there is none."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found on PATH or under CUDA_HOME; the port's CUDA kernels "
        "are built from source at first use and need the CUDA toolkit"
    )


def library_path(name: str) -> Path:
    """Where the library of kernel ``name`` lives once built."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names=KERNELS, timeout_s: float = 600.0) -> dict[str, dict]:
    """Compile every kernel in ``names`` that is not built yet: one ``nvcc``
    per source, all started together.

    Returns ``{name: {"seconds": s, "cached": bool, "log": nvcc output}}``.
    Raises RuntimeError naming the sources that failed, with their logs;
    ``subprocess.TimeoutExpired`` when an ``nvcc`` runs past ``timeout_s``
    (every ``nvcc`` still running is killed first).
    """
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    report: dict[str, dict] = {}
    running: dict[str, tuple] = {}
    failed: list[str] = []
    t0 = time.perf_counter()
    try:
        for name in names:
            out = library_path(name)
            if out.exists():
                report[name] = {"seconds": 0.0, "cached": True, "log": ""}
                continue
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            running[name] = (proc, tmp, out)
        for name, (proc, tmp, out) in running.items():
            left = max(1.0, timeout_s - (time.perf_counter() - t0))
            log, _ = proc.communicate(timeout=left)
            if proc.returncode != 0 or not tmp.exists():
                tmp.unlink(missing_ok=True)
                failed.append(f"nvcc failed to build {name}.cu (exit {proc.returncode}):\n{log}")
                continue
            os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
            report[name] = {"seconds": time.perf_counter() - t0, "cached": False,
                            "log": log}
    finally:
        for proc, tmp, _ in running.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
                tmp.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build((name,))
            lib = _LIBS[name] = ctypes.CDLL(str(path))
        return lib


@functools.cache
def _floor_kernel():
    """``tf_launch_floor`` of the built library, its C signature declared."""
    fn = load("launch_floor").tf_launch_floor
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch_floor(device: torch.device | str = "cuda") -> None:
    """Launch the empty kernel of ``csrc/launch_floor.cu`` on the current
    stream of ``device``, a CUDA device: there is nothing to compute, so
    there is no plain version, and any other device raises.
    ``launch_floor.launches`` counts launches."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the launch floor is a kernel of the card; got device {device}")
    with torch.cuda.device(device):
        rc = _floor_kernel()(torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"launch floor kernel launch failed: CUDA error {rc}")
    launch_floor.launches += 1


launch_floor.launches = 0
