"""Build and load the port's CUDA kernels.

Every `csrc/<name>.cu` compiles with nvcc into a shared library with a
plain C interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o <lib> csrc/<name>.cu

The host library `csrc/<name>.cc` (the normalizer of `ops/native.py`)
compiles with the host C++ compiler, `$CXX` or g++:

    g++ -O3 -march=native -fPIC -std=c++17 -pthread -shared -o <lib> csrc/<name>.cc

The library lands in `echoflow_torch/_build/` (git-ignored) under a name
that carries the hash of its source, compiler and flags, so an edited
source rebuilds and an unchanged one is reused. `-march=native` makes a
host library fit the machine that built it: `_build/` is not shared
between machines. Building happens at first use, never at import. A
missing compiler or a failed compile raises: there is no fallback to the
plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-pthread", "-shared")

_lock = threading.Lock()
_libs: dict = {}
build_logs: dict = {}  # name -> the compiler's output (ptxas registers/spills)


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        candidate = Path(cuda_home) / "bin" / "nvcc"
        nvcc = str(candidate) if candidate.exists() else None
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
            "CUDA kernels of echoflow_torch cannot be built")
    return nvcc


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def host_compiler() -> str:
    return os.environ.get("CXX", "g++")


def host_library_path(name: str, cxx: str) -> Path:
    src = CSRC / f"{name}.cc"
    flags = " ".join((cxx,) + CXX_FLAGS)
    digest = hashlib.sha256(src.read_bytes() + flags.encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-host-{digest[:16]}.so"


def _compile(jobs: dict) -> None:
    """Run each job, {name: (compiler argv without its output, library
    path)}, all started together; each compiler writes a temporary file
    that is renamed into place. Raises if any fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    failed = []
    for name, (argv, path) in jobs.items():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            procs[name] = (tmp, path, subprocess.Popen(
                [*argv, "-o", tmp], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        except OSError as exc:   # the compiler itself is missing
            os.unlink(tmp)
            failed.append(f"{name}: {argv[0]}: {exc}")
    for name, (tmp, path, proc) in procs.items():
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}: {proc.args[0]} exit {proc.returncode}\n{log}")
        else:
            os.replace(tmp, path)  # atomic: readers never see a partial file
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))


def build_all(names=None) -> dict:
    """Compile every named CUDA source (default: all of csrc/*.cu) that has
    no library for its current hash, one nvcc process per source, all
    started together. Returns {name: library path}; raises if any compile
    fails."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    paths = {name: library_path(name) for name in names}
    todo = {name: path for name, path in paths.items() if not path.exists()}
    if todo:
        nvcc = find_nvcc()
        _compile({name: ([nvcc, *NVCC_FLAGS, str(CSRC / f"{name}.cu")], path)
                  for name, path in todo.items()})
    return paths


def build_host(name: str) -> Path:
    """The host library of csrc/<name>.cc for the current compiler, built
    first if it is not there; raises if the compile fails."""
    cxx = host_compiler()
    path = host_library_path(name, cxx)
    if not path.exists():
        _compile({name: ([cxx, *CXX_FLAGS, str(CSRC / f"{name}.cc")], path)})
    return path


def _load(key: str, build) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            lib = _libs[key] = ctypes.CDLL(str(build()))
        return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    return _load(name, lambda: build_all([name])[name])


def load_host(name: str) -> ctypes.CDLL:
    """The loaded host library of csrc/<name>.cc, built first if needed."""
    return _load(name + ".cc", lambda: build_host(name))
