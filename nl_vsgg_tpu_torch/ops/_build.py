"""Build the port's CUDA sources with nvcc at first use; load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface (pointers and the stream
as `void*`, sizes as ints, the launch's cudaError_t as the return value),
so it compiles in seconds with no PyTorch headers. The shared library goes
to `build/torch_kernels/lib<name>-<hash>.so` beside the package, named by a
hash of the source and the flags, so an edited source is rebuilt and an
unchanged one is built once per checkout. `build_all` starts one nvcc per
source, all at once. Nothing is built when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "torch_kernels")
SOURCES = ("masked_attention", "roi_align", "grouped_conv")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                           "port's CUDA kernels are built on the GPU machine")
    return path


def library_path(name: str) -> str:
    with open(os.path.join(CSRC, name + ".cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"lib{name}-{digest[:12]}.so")


def build_all(names=SOURCES) -> dict[str, float]:
    """Build every named source not built yet, one nvcc each, in parallel.
    Returns each build's seconds (0.0 when already built). The compiler's
    report (registers, shared memory, spills) is kept beside the library
    as `<library>.log`."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = {}
    t0 = time.perf_counter()
    for name in names:
        target = library_path(name)
        if os.path.isfile(target):
            continue
        tmp = f"{target}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name + ".cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, target)
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, target) in jobs.items():
        report, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        with open(target + ".log", "w") as f:
            f.write(report)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{report}")
            continue
        os.replace(tmp, target)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The built library of `csrc/<name>.cu`, building it on first use."""
    lib = _loaded.get(name)
    if lib is None:
        build_all((name,))
        lib = _loaded[name] = ctypes.CDLL(library_path(name))
    return lib
