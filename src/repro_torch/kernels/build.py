"""Build the port's CUDA kernels from the sources in the checkout.

Each kernel is a ``.cu`` file with a plain C entry point, compiled by
``nvcc`` for Hopper (``-gencode arch=compute_90a,code=sm_90a -O3``) into a
shared library and loaded with ``ctypes``: no PyTorch headers, so a build
takes seconds. A kernel's sources are its ``.cu`` files, which ``nvcc``
compiles, and the headers they include, which only enter the hash.
Libraries land in ``build/repro_torch_ext/`` at the repo root, named by a
hash of their sources (an edited source rebuilds), with
the compiler's ``-Xptxas -v`` report beside them (``<name>.log``).
Nothing builds at import time: the first launch of a kernel builds it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch_ext"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_loaded = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the "
                           "port's CUDA kernels build on a machine with the "
                           "CUDA toolkit")
    return str(path)


def library_path(name: str, sources) -> Path:
    h = hashlib.sha1()
    for src in sources:
        h.update(Path(src).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(name: str, sources) -> Path:
    """Compile ``sources`` into ``lib<name>-<hash>.so`` unless it exists;
    raises with the compiler's output when ``nvcc`` fails."""
    so = library_path(name, sources)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".tmp{os.getpid()}")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(s) for s in sources if Path(s).suffix == ".cu")]
    r = subprocess.run(cmd, capture_output=True, text=True)
    (BUILD_DIR / f"{name}.log").write_text(
        " ".join(cmd) + "\n" + r.stdout + r.stderr)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed building {name} "
                           f"(rc {r.returncode}):\n{r.stdout}{r.stderr}")
    os.replace(tmp, so)
    return so


def load(name: str, sources) -> ctypes.CDLL:
    """Build (if needed) and load one kernel library, once per process."""
    lib = _loaded.get(name)
    if lib is None:
        lib = _loaded[name] = ctypes.CDLL(str(build(name, sources)))
    return lib
