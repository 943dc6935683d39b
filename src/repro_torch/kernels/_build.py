"""Build and load the hand-written CUDA kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, which is
loaded with ``ctypes``.  The build happens at first use, never at import:
every source is compiled at once, one ``nvcc`` process each, started
together.  Libraries go to ``build/repro_torch/`` at the repository root
(``REPRO_TORCH_BUILD_DIR`` overrides it), named by a hash of the source,
the shared headers (``csrc/*.cuh``) and the flags, so an edited source or
header is rebuilt and an unchanged one is reused.
The compiler's resource report (``-Xptxas -v``) is kept beside each library
as ``<name>.log``.

A failed build raises :class:`KernelLoweringError`; there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

from ..errors import DispatchError, KernelLoweringError

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("dense_tile_spmm", "gather_spmm", "sddmm", "structured_spmm")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# the toolkit's usual home, tried after $CUDA_HOME/bin and $PATH
NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"
_REPO_ROOT = Path(__file__).resolve().parents[3]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_FUNCS: Dict[str, ctypes._CFuncPtr] = {}


def build_dir() -> Path:
    return Path(os.environ.get("REPRO_TORCH_BUILD_DIR",
                               _REPO_ROOT / "build" / "repro_torch"))


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        NVCC_DEFAULT,
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise KernelLoweringError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels are built from source at first use")


def library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a hash of that source,
    every shared header ``csrc/*.cuh`` (a source may include any of them)
    and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Sequence[str] = SOURCES) -> Dict[str, Path]:
    """Compile every stale library among ``names``, all nvcc's in parallel."""
    targets = {name: library_path(name) for name in names}
    stale = {n: p for n, p in targets.items() if not p.exists()}
    if not stale:
        return targets
    nvcc = _nvcc()
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, path in stale.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), tmp)
    failures = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        (build_dir() / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, stale[name])
    if failures:
        raise KernelLoweringError("nvcc failed:\n" + "\n".join(failures))
    return targets


def function(library: str, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of ``library``, built on first use.

    Every entry point returns ``int`` (a ``cudaError_t``; 0 is success).
    """
    key = f"{library}:{symbol}"
    with _LOCK:
        fn = _FUNCS.get(key)
        if fn is None:
            if library not in _LIBS:
                paths = build_all()
                for name, path in paths.items():
                    _LIBS.setdefault(name, ctypes.CDLL(str(path)))
            fn = getattr(_LIBS[library], symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _FUNCS[key] = fn
        return fn


def resolved_count() -> int:
    """Kernel entry points resolved so far: a call that raises it built or
    loaded a kernel library (the telemetry profiler marks such calls)."""
    with _LOCK:
        return len(_FUNCS)


def check_status(status: int, kernel: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a launch."""
    if status != 0:
        raise DispatchError(
            f"{kernel} launch failed with cudaError_t {status}")
