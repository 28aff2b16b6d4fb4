"""Build and load the package's hand-written CUDA kernels.

Each ``.cu`` source under ``gags_torch/<sub>/csrc/`` exposes a plain C
interface and is compiled with ``nvcc`` into its own shared library under
``build/gags_torch/`` in the checkout, at first use; ctypes loads it. No
PyTorch header is included, so a build takes seconds, not minutes.

Libraries are named after a hash of their source and flags, so an edited
source is rebuilt and an unchanged one is reused. Compilation goes to a
temporary name and is renamed into place, so two processes building the
same library never see a half-written file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent
BUILD_DIR = PACKAGE_DIR.parent / "build" / "gags_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """Locate nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    which = shutil.which("nvcc")
    if which:
        cands.append(which)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("gags_torch: nvcc not found (set CUDA_HOME)")


def _lib_path(source: Path) -> Path:
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}-{h.hexdigest()[:16]}.so"


def _start_build(source: Path) -> tuple[Path, Path, subprocess.Popen] | None:
    out = _lib_path(source)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return out, tmp, proc


def build(sources: list[Path]) -> dict[str, str]:
    """Compile every source that has no library yet, all nvcc processes at
    once. Returns {source stem: compiler log} for every source; the log,
    kept beside the library, carries ptxas' register and spill report."""
    jobs = [j for j in (_start_build(s) for s in sources) if j is not None]
    failed = []
    for out, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{out.name}:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("gags_torch: nvcc failed\n" + "\n".join(failed))
    logs = {}
    for s in sources:
        log = _lib_path(s).with_suffix(".log")
        logs[s.stem] = log.read_text() if log.exists() else ""
    return logs


def load(source: Path) -> ctypes.CDLL:
    """The loaded library for `source`, building it on first use."""
    key = str(source)
    with _lock:
        lib = _loaded.get(key)
        if lib is None:
            build([source])
            lib = ctypes.CDLL(str(_lib_path(source)))
            lib.gags_error_string.argtypes = [ctypes.c_int]
            lib.gags_error_string.restype = ctypes.c_char_p
            _loaded[key] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if err != 0:
        msg = lib.gags_error_string(err).decode()
        raise RuntimeError(f"gags_torch: {what} launch failed: {msg} ({err})")
