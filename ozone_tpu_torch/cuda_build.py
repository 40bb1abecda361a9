"""Build the port's native sources into shared libraries at first use.

Each `csrc/<name>.cu` (a CUDA kernel), `csrc/<name>.cpp` (host code) or
`csrc/lib<name>/<name>.c` (the C client libo3fs) exports a plain C
interface. A `.cu` file is compiled with `nvcc` for `sm_90a`, a `.cpp`
file with `g++ -O3 -msse4.2` (the GF coder and the chunk datapath sidecar
with `-O3 -march=native -pthread`, as the reference builds its own
copies), a `.c` file with `gcc -O2` (the reference's flags), into
`_build/lib<name>-<hash>.so`, where the hash covers the source and
the flags, and for `-march=native` what the compiler makes of it on this
host, so an edited source, or a library built for another CPU, never
loads. Each compiler writes a temporary file that is renamed into place,
so processes that build the same library at once never load a
half-written one. The library is then loaded with ctypes. Nothing is
compiled at import time; `load(name)` compiles on its first call in a
process and caches the handle, and `build_all()` compiles every source
at once, one compiler process per file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from functools import lru_cache
from pathlib import Path

PKG = Path(__file__).resolve().parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: host sources: SSE4.2 for the crc32 instruction (without it the
#: reference's bitwise fallback compiles instead)
GXX_FLAGS = ("-O3", "-msse4.2", "-shared", "-fPIC", "-std=c++17")
#: host sources with flags of their own: the GF coder is built for the
#: host's own vector units (AVX2 where it has them), with the flags of
#: the reference's native coder (ozone_tpu/native/__init__.py:53-54)
HOST_FLAGS = {
    "gf_coder": ("-O3", "-march=native", "-pthread", "-shared", "-fPIC",
                 "-std=c++17"),
    #: the chunk datapath sidecar, with the reference's flags
    #: (ozone_tpu/storage/fast_datapath.py:69-71)
    "datapath": ("-O3", "-march=native", "-std=c++17", "-pthread", "-shared",
                 "-fPIC"),
    #: the LD_PRELOAD filesystem interposer, with the reference's flags
    #: (ozone_tpu/native/__init__.py build_shared, extra -ldl)
    "failure_injector": ("-O2", "-shared", "-fPIC", "-ldl"),
}

#: sources that are built but never loaded into this process: the
#: interposer goes into a child's LD_PRELOAD (`testing/fault_injection.py`)
PRELOAD_ONLY = frozenset({"failure_injector"})
#: programs, not libraries: the sanitizer selftest program is compiled by
#: its test with the sanitizer's flags, never here
PROGRAMS = frozenset({"gf_coder_selftest"})

#: C sources (libo3fs), with the reference's flags
#: (ozone_tpu/native/__init__.py build_shared)
GCC_FLAGS = ("-O2", "-shared", "-fPIC")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: name -> (seconds, the compiler's output) of the builds this process ran
build_log: dict[str, tuple[float, str]] = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is required "
                           "to build the port's kernels")
    return path


def gxx() -> str:
    path = shutil.which("g++") or shutil.which("c++")
    if path is None:
        raise RuntimeError("g++ not found: a C++ compiler is required to "
                           "build the port's host libraries")
    return path


def gcc() -> str:
    path = shutil.which("gcc") or shutil.which("cc")
    if path is None:
        raise RuntimeError("gcc not found: a C compiler is required to "
                           "build libo3fs")
    return path


def _source(name: str) -> Path:
    for src in (CSRC / f"{name}.cu", CSRC / f"{name}.cpp",
                CSRC / f"lib{name}" / f"{name}.c"):
        if src.exists():
            return src
    raise FileNotFoundError(f"no csrc/{name}.cu, csrc/{name}.cpp or "
                            f"csrc/lib{name}/{name}.c")


def _flags(src: Path) -> tuple[str, ...]:
    if src.suffix == ".cu":
        return NVCC_FLAGS
    if src.suffix == ".c":
        return GCC_FLAGS
    return HOST_FLAGS.get(src.stem, GXX_FLAGS)


def _command(src: Path) -> list[str]:
    compiler = {".cu": nvcc, ".c": gcc}.get(src.suffix, gxx)
    return [compiler(), *_flags(src)]


@lru_cache(maxsize=None)
def _native_target() -> bytes:
    """The compiler's predefined macros under -march=native: which vector
    extensions "native" turns on for this host's CPU."""
    return subprocess.run(
        [gxx(), "-march=native", "-dM", "-E", "-x", "c++", os.devnull],
        capture_output=True, check=True, timeout=120).stdout


def _target(name: str) -> tuple[Path, Path]:
    src = _source(name)
    flags = _flags(src)
    key = src.read_bytes() + " ".join(flags).encode()
    if src.suffix == ".c":  # the header beside it
        key += b"".join(h.read_bytes() for h in sorted(src.parent.glob("*.h")))
    if "-march=native" in flags:
        key += _native_target()
    digest = hashlib.sha256(key).hexdigest()[:12]
    return src, BUILD / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start the compiler for `name` unless its library exists; returns
    (target, tmp, process, t0) or None."""
    src, so = _target(name)
    if so.exists():
        return None
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.Popen([*_command(src), "-o", str(tmp), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return so, tmp, proc, time.perf_counter()


def _finish(name: str, job) -> None:
    so, tmp, proc, t0 = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"compiling csrc/{name} failed:\n{log}")
    os.replace(tmp, so)
    build_log[name] = (time.perf_counter() - t0, log)


def build_all() -> dict[str, tuple[float, str]]:
    """Compile every csrc library, kernels and host libraries, in parallel
    (one compiler process each) and load them (the interposer is built,
    not loaded)."""
    names = sorted(({p.stem for p in CSRC.glob("*.cu")}
                    | {p.stem for p in CSRC.glob("*.cpp")}
                    | {p.stem for p in CSRC.glob("lib*/*.c")}) - PROGRAMS)
    with _lock:
        jobs = {n: _start(n) for n in names if n not in _libs}
        for n, job in jobs.items():
            if job is not None:
                _finish(n, job)
    for n in names:
        if n not in PRELOAD_ONLY:
            load(n)
    return dict(build_log)


def build(name: str) -> Path:
    """The path of csrc/<name>'s library, compiling it if needed, without
    loading it (the interposer is only ever preloaded into a child)."""
    with _lock:
        job = _start(name)
        if job is not None:
            _finish(name, job)
        return _target(name)[1]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>, compiling it if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            job = _start(name)
            if job is not None:
                _finish(name, job)
            lib = _libs[name] = ctypes.CDLL(str(_target(name)[1]))
        return lib
