"""Build and ctypes bindings of the batched classic-control engine
(`vecenv.cpp`, a copy of the JAX package's `native/vecenv.cpp`).

`load()` compiles the source at its first call with the system g++,

    g++ -O3 -march=native -ffp-contract=off -shared -fPIC vecenv.cpp \
        -o <cache>/native/_vecenv-<hash>.so

into the build cache's `native/` directory (`utils/compile_cache.py`: by
default `build/native/` at the root of the checkout, listed in
`.gitignore`; `--compile-cache-dir` moves it). The name carries a hash of
the source and of `CXX_FLAGS`, as the kernel libraries' do, and of the
host CPU's model and flags (`-march=native` builds for them), so an
edited source is rebuilt and a stale engine is never loaded, also from a
cache that another checkout or machine shares; a library already there is a cache hit
(recorded as a `compile` event with `cache_hit`). The build writes a
per-process temporary name and renames it into place, so that a
concurrent process never opens a half-written library, and concurrent
callers in one process (the warm-up's thread and a pool's constructor)
take turns. Nothing is built at import. The JAX package's own library
(`actor_critic_tpu/native/_vecenv.so`) is never read or written.

`-ffp-contract=off` is load-bearing: gymnasium's NumPy arithmetic never
fuses a multiply and an add, and FMA contraction (the default under -O3)
breaks the engine's bit parity with it (a 1-ulp velocity difference in
MountainCar's `force * power - cosTerm`). A missing or failing compiler
raises `ImportError`; the caller gets no gymnasium stand-in.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

SRC = Path(__file__).resolve().parent / "vecenv.cpp"
CXX_FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-shared", "-fPIC")

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_u64p = ctypes.POINTER(ctypes.c_uint64)
_f32p = ctypes.POINTER(ctypes.c_float)
_f64p = ctypes.POINTER(ctypes.c_double)


_lock = threading.RLock()
_loaded: dict[Path, ctypes.CDLL] = {}


def _host_cpu() -> bytes:
    """The host CPU's model and feature flags (`-march=native` compiles for
    them, so a library built on another CPU may not run here)."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = [x for x in f if x.startswith(("model name", "flags"))]
        return "".join(sorted(set(lines))).encode()
    except OSError:
        return platform.processor().encode()


def library_path() -> Path:
    """The engine's library in the build cache: `_vecenv-<hash>.so`, the
    hash of the source, of `CXX_FLAGS` and of the host CPU."""
    from actor_critic_tpu_torch.utils import compile_cache

    digest = hashlib.sha256(
        SRC.read_bytes() + " ".join(CXX_FLAGS).encode() + _host_cpu()).hexdigest()[:12]
    return compile_cache.cache_path("native") / f"_vecenv-{digest}.so"


def build() -> Path:
    """The engine's library: found in the build cache (one `compile` event
    with `cache_hit`), or compiled there (one `compile` event with its g++
    seconds). Raises ImportError with the compiler's output when g++ is
    missing or fails."""
    from actor_critic_tpu_torch.telemetry import profiler

    out = library_path()
    with _lock:
        if out.exists():
            profiler.record_build("vecenv.cpp", 0.0, " ".join(CXX_FLAGS), cache_hit=True)
            return out
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        try:
            with profiler.record_compile("vecenv.cpp", " ".join(CXX_FLAGS), capture=False):
                subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                               check=True, capture_output=True, text=True)
            os.replace(tmp, out)
        except FileNotFoundError as e:
            raise ImportError(f"the native env engine needs g++ to build: {e}") from e
        except subprocess.CalledProcessError as e:
            raise ImportError(f"the native env engine failed to build:\n{e.stderr}") from e
        finally:
            tmp.unlink(missing_ok=True)
    return out


def load() -> ctypes.CDLL:
    """The compiled engine (built first where the cache has none), bound
    once a process for each library path."""
    with _lock:
        path = library_path()
        lib = _loaded.get(path)
        if lib is None:
            lib = _loaded[path] = _bind(ctypes.CDLL(str(build())))
        return lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    for prefix, act in (("cartpole", _i64p), ("pendulum", _f32p), ("mountaincar", _f32p),
                        ("acrobot", _i64p)):
        reset, step = getattr(lib, f"{prefix}_reset"), getattr(lib, f"{prefix}_step")
        reset.argtypes = [_f64p, _f32p, ctypes.c_int, _u64p, _i32p]
        step.argtypes = [_f64p, act, ctypes.c_int, _u64p, _i32p, ctypes.c_int32,
                         _f32p, _f32p, _u8p, _u8p, _f32p]
        reset.restype = step.restype = None
    lib.set_state.argtypes = [_f64p, _f64p, ctypes.c_int, ctypes.c_int]
    lib.set_state.restype = None
    return lib
