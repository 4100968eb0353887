"""Build the package's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes plain C entry points and compiles on first
use into its own shared library for ``sm_90a``, under ``build/proben_tpu_torch``
at the repository root (git-ignored). Libraries are keyed by a hash of the
source, every local header in ``csrc/`` and every flag (the common ones and a
library's own libraries, ``LINK_LIBS``), so an edited source or header, or
a changed flag or include path, rebuilds. Every entry point
returns ``cudaGetLastError()`` after its launch; :func:`check` raises on a
non-zero code, so a refused launch never passes silently.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "proben_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

# libraries a source links against, beyond the CUDA runtime
LINK_LIBS = {"image_io": ("nvjpeg",)}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then ``PATH``,
    then ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def link_flags(name: str) -> List[str]:
    """``-l`` flags of ``csrc/<name>.cu``'s libraries, with the toolkit's
    library directory as the run path, so the loader finds them there."""
    libs = LINK_LIBS.get(name, ())
    if not libs:
        return []
    lib_dir = Path(nvcc()).resolve().parent.parent / "lib64"
    return [f"-l{lib}" for lib in libs] + ["-Xlinker", f"-rpath={lib_dir}"]


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to: keyed by the source, each header
    in ``csrc/`` (any source may include it) and the flags."""
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS + tuple(LINK_LIBS.get(name, ()))).encode())
    for path in [CSRC / f"{name}.cu"] + sorted(
            p for p in CSRC.iterdir() if p.suffix in (".cuh", ".h", ".hpp")):
        h.update(b"\0" + path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> List[Path]:
    """Compile every missing library in ``names``, one ``nvcc`` process per
    source, all started together. Returns the library paths."""
    names = list(names)
    outs = [library_path(n) for n in names]
    procs = []
    for name, out in zip(names, outs):
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu"), *link_flags(name)]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    return outs


def load(name: str, signatures: Dict[str, list]) -> ctypes.CDLL:
    """Load (building first if needed) ``csrc/<name>.cu`` and declare the
    argument types of its entry points; each returns an ``int`` error code."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[0]))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _libs[name] = lib
    return lib


def check(code: int, what: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")
