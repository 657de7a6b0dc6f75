"""Build and ctypes bindings of the batched classic-control engine
(`vecenv.cpp`, a copy of the JAX package's `native/vecenv.cpp`).

`load()` compiles the source at its first call with the system g++,

    g++ -O3 -march=native -ffp-contract=off -shared -fPIC vecenv.cpp \
        -o build/native/_vecenv.so

into `build/native/` at the root of the checkout (listed in `.gitignore`),
under a per-process temporary name renamed into place, so that a
concurrent process never opens a half-written library; it builds again
when `vecenv.cpp` is newer than the library. Nothing is built at import.
The JAX package's own library (`actor_critic_tpu/native/_vecenv.so`) is
never read or written.

`-ffp-contract=off` is load-bearing: gymnasium's NumPy arithmetic never
fuses a multiply and an add, and FMA contraction (the default under -O3)
breaks the engine's bit parity with it (a 1-ulp velocity difference in
MountainCar's `force * power - cosTerm`). A missing or failing compiler
raises `ImportError`; the caller gets no gymnasium stand-in.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
from pathlib import Path

SRC = Path(__file__).resolve().parent / "vecenv.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
LIB = BUILD_DIR / "_vecenv.so"
CXX_FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-shared", "-fPIC")

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_u64p = ctypes.POINTER(ctypes.c_uint64)
_f32p = ctypes.POINTER(ctypes.c_float)
_f64p = ctypes.POINTER(ctypes.c_double)


def build() -> Path:
    """Compile `vecenv.cpp` into `LIB`; raises ImportError with the
    compiler's output when g++ is missing or fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIB.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, LIB)
    except FileNotFoundError as e:
        raise ImportError(f"the native env engine needs g++ to build: {e}") from e
    except subprocess.CalledProcessError as e:
        raise ImportError(f"the native env engine failed to build:\n{e.stderr}") from e
    finally:
        tmp.unlink(missing_ok=True)
    return LIB


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """The compiled engine, built first when there is no library or the
    source is newer than it."""
    if not LIB.exists() or LIB.stat().st_mtime < SRC.stat().st_mtime:
        build()
    lib = ctypes.CDLL(str(LIB))
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
