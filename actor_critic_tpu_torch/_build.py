"""Builds the port's CUDA kernels from `csrc/` and loads them with ctypes.

Each `csrc/<name>.cu` exposes a plain `extern "C"` launcher and is compiled
at first use, on the machine with the card, by

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o <cache>/kernels/lib<name>-<hash>.so csrc/<name>.cu

into the build cache's `kernels/` directory (`utils/compile_cache.py`: by
default `build/kernels/` at the root of the checkout, listed in
`.gitignore`; `--compile-cache-dir` moves it). The library name carries a
hash of the source, of the shared headers (`csrc/*.cuh`) and of the
flags, so an edited source is rebuilt and a stale library is never
loaded, also from a cache that other checkouts share. `build()` compiles
several sources at once, one `nvcc` process each, all started together;
concurrent callers (the warm-up's thread and a first launch) take turns,
so a library is built once.
Each kernel counts its own launches on the card (`csrc/scan_tile.cuh::
count_launch`); `device_launches` reads those counts.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Iterable

CSRC = Path(__file__).resolve().parent / "csrc"

ARCH = "sm_90a"
NVCC_FLAGS = (
    "-gencode", f"arch=compute_90a,code={ARCH}",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_loaded: dict[str, ctypes.CDLL] = {}
# name -> (seconds, compiler output) of the builds this process ran.
build_log: dict[str, tuple[float, str]] = {}
_build_lock = threading.Lock()


def build_dir() -> Path:
    """Where the libraries are built and looked up: the build cache's
    `kernels/` directory."""
    from actor_critic_tpu_torch.utils import compile_cache

    return compile_cache.cache_path("kernels")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    sources = [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]
    digest = hashlib.sha256(
        b"".join(p.read_bytes() for p in sources) + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:12]
    return build_dir() / f"lib{name}-{digest}.so"


def build(*names: str) -> dict[str, Path]:
    """Compile every named source that has no up-to-date library, in
    parallel; raise with the compiler's output if any build fails. Each
    source is recorded as one `compile` event (`telemetry/profiler.py`:
    its nvcc seconds and arch; a library already built is a cache hit)."""
    with _build_lock:
        return _build(names)


def _build(names) -> dict[str, Path]:
    from actor_critic_tpu_torch.telemetry import profiler

    build_dir().mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            profiler.record_build(f"{name}.cu", 0.0, ARCH, cache_hit=True)
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out, time.perf_counter(),
        )
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        text, _ = proc.communicate()
        build_log[name] = (time.perf_counter() - t0, text)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{text}")
            continue
        os.replace(tmp, out)  # atomic: a reader never sees a half-written library
        profiler.record_build(f"{name}.cu", build_log[name][0], ARCH)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of kernel library `name`, built at first use."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)[name]))
        _loaded[name] = lib
    return lib


def device_launches(name: str, devices: Iterable[int], reset: bool = False) -> int:
    """The launches of kernel library `name`'s kernel that ran on `devices`,
    summed: each device's counter is read by `<name>_launches` once the
    device's work has finished, then zeroed where `reset` is set."""
    import torch

    total = 0
    for index in devices:
        read = getattr(load(name), f"{name}_launches")
        if read.argtypes is None:
            read.argtypes = [ctypes.POINTER(ctypes.c_ulonglong), ctypes.c_int]
            read.restype = ctypes.c_int
        torch.cuda.synchronize(index)
        out = ctypes.c_ulonglong()
        with torch.cuda.device(index):
            err = read(ctypes.byref(out), int(reset))
        if err != 0:
            raise RuntimeError(f"reading the {name} kernel's launch count failed: cudaError {err}")
        total += out.value
    return total
