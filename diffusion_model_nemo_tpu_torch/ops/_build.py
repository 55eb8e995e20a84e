"""Build and load the hand-written Hopper kernels in ``csrc/``.

Each ``csrc/*.cu`` file is compiled by its own ``nvcc`` process (all started
together) into a shared library with a plain C interface, and loaded with
``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o <build>/<name>-<hash>.so csrc/<name>.cu

The build runs at first use, into ``_build/`` beside this package (listed in
``.gitignore``); a library's file name carries the hash of its sources, so an
edited source is rebuilt and a stale library is never loaded. A failed
build raises with the compiler's output. Only the repository's own sources
are compiled.
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
from typing import Dict, List

__all__ = [
    "load_kernels", "build_kernels", "library", "launch", "CSRC_DIR", "BUILD_DIR", "build_seconds",
]

_PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_seconds = {"total": 0.0}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin, default "
        "/usr/local/cuda/bin): the Hopper kernels cannot be built"
    )


def _sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _lib_path(src: Path) -> Path:
    h = hashlib.sha256()
    for dep in [src] + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(dep.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_kernels() -> Dict[str, Path]:
    """Compile every source that has no up-to-date library, one ``nvcc``
    process per source, all in parallel. Returns {stem: library path}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {src.stem: (src, _lib_path(src)) for src in _sources()}
    todo = {k: v for k, v in targets.items() if not v[1].exists()}
    if todo:
        nvcc = _nvcc()
        t0 = time.perf_counter()
        procs = {}
        for stem, (src, out) in todo.items():
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, f"-I{CSRC_DIR}", "-o", str(tmp), str(src)]
            procs[stem] = (
                subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
                ),
                tmp,
                out,
            )
        errors = []
        for stem, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"--- nvcc {stem}.cu (exit {proc.returncode}) ---\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)
        build_seconds["total"] += time.perf_counter() - t0
        if errors:
            raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return {stem: out for stem, (_src, out) in targets.items()}


def load_kernels() -> Dict[str, ctypes.CDLL]:
    """Build (at first use) and load every kernel library; thread-safe."""
    with _lock:
        if not _libs:
            for stem, path in build_kernels().items():
                _libs[stem] = ctypes.CDLL(str(path))
        return _libs


def library(stem: str) -> ctypes.CDLL:
    return load_kernels()[stem]


def launch(stem: str, name: str, argtypes, *args) -> None:
    """Call one C launcher of library ``stem`` and raise if it returns a
    CUDA error (a refused launch never runs, and a later synchronize would
    not report it)."""
    lib = library(stem)
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    rc = fn(*args)
    if rc != 0:
        err = getattr(lib, f"dmn_{_ERROR_PREFIX[stem]}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        raise RuntimeError(f"{stem}.cu:{name} failed: CUDA error {rc} ({err(rc).decode()})")


_ERROR_PREFIX = {
    "group_norm_silu": "gn",
    "group_norm_bm": "gn_bm",
    "linear_attention": "linattn",
    "attention_block_small": "attn_small",
    "attention": "attn",
}
