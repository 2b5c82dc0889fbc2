"""Build the CUDA sources of ``repro_torch/csrc`` and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first
use into ``build/repro_torch/lib<name>-<digest>.so`` at the root of the
checkout, where ``<digest>`` hashes the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source is never served from a
stale library.  Nothing is built when a module is imported: the CPU path
never needs ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Iterable, Mapping, Optional, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

# Hopper with its architecture-specific features (wgmma, setmaxnreg);
# "-Xptxas -v" puts each kernel's registers, shared memory and spills in
# the log that build() returns.
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-shared", "-Xcompiler",
                           "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then the
    toolkit's default install location."""
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def source(name: str) -> Path:
    return CSRC / f"{name}.cu"


def library_path(name: str) -> Path:
    h = hashlib.sha1(source(name).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):   # shared loops
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    """Start ``nvcc`` for ``name`` unless its library exists; returns
    (library path, temporary output, process or None)."""
    out = library_path(name)
    if out.exists():
        return out, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.Popen(
        [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source(name))],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def build(names: Optional[Iterable[str]] = None) -> dict[str, str]:
    """Compile every named source (default: all of ``csrc``), one ``nvcc``
    per source, all started together.  Returns each compiler's output
    (empty for a library that was already built); raises on a failure."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    started = {n: _start(n) for n in names}
    logs, failed = {}, []
    for name, (out, tmp, proc) in started.items():
        if proc is None:
            logs[name] = ""
            continue
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n"
                          f"{logs[name]}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, out)          # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return logs


def load(name: str,
         signatures: Mapping[str, Sequence[type]]) -> ctypes.CDLL:
    """The built library ``name`` (building it on first use), with
    ``argtypes`` set from ``signatures`` and ``restype`` int for each
    entry point (every entry point returns a ``cudaError_t``)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            _LIBS[name] = lib
        return lib
