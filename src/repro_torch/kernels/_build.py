"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` into a shared library with a plain C
interface, loaded with ``ctypes`` — no PyTorch headers, so a build takes
seconds.  Libraries go to ``kernels/_build/`` (ignored by git), named by a
hash of the source, the headers it includes and the flags, so an edited
source rebuilds and an unchanged one is reused.  :func:`build_all` starts
one ``nvcc`` per source, all at once.  Nothing builds at import: the
first launch builds what it needs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def sources() -> list[str]:
    """Stems of every kernel source in the checkout."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return found


def library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a hash of the source, the
    ``csrc`` headers it includes and the flags."""
    text = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join((CSRC / h.decode()).read_bytes()
                       for h in re.findall(rb'#include "([^"]+)"', text))
    digest = hashlib.sha256(text + headers + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _start(name: str) -> tuple[Path, Path, subprocess.Popen] | None:
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return out, tmp, proc


def build_all(names: list[str] | None = None) -> dict[str, str]:
    """Compile every (or the named) source in parallel; returns each
    build's compiler report (``-Xptxas -v``: registers, shared memory,
    spills), empty for libraries already built.  Raises on a failed build."""
    started = {n: _start(n) for n in (names or sources())}
    reports, failed = {}, []
    for name, job in started.items():
        if job is None:
            reports[name] = ""
            continue
        out, tmp, proc = job
        log, _ = proc.communicate()
        reports[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(library_path(name)))
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def error_string(lib: ctypes.CDLL, err: int) -> str:
    return lib.repro_error_string(err).decode()
