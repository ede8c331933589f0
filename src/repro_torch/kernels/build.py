"""Build the CUDA sources under ``kernels/csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface (no PyTorch headers, so a build takes
seconds).  Libraries land in ``build/repro_torch/`` at the repository root,
named by a hash of the source and the flags: an edited source builds anew, an
unchanged one is reused.  There is no fallback: without ``nvcc``, or when the
compiler fails, :func:`build` raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Dict, List, Sequence

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "find_nvcc", "build", "load", "sources"]

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def sources() -> List[str]:
    """Names of the kernel sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``, else PATH."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(pathlib.Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    cands.append(pathlib.Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found ($CUDA_HOME/bin, /usr/local/cuda/bin, PATH): the CUDA "
        "kernels of repro_torch need the CUDA toolkit to build"
    )


def _lib_path(name: str) -> pathlib.Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names: Sequence[str] = ()) -> Dict[str, pathlib.Path]:
    """Compile ``names`` (default: every source) in parallel, one ``nvcc``
    each, all started together.  Returns name -> library path; the compiler
    output (``-Xptxas -v``: registers, spills) is kept beside it as ``.log``."""
    names = list(names) or sources()
    out = {n: _lib_path(n) for n in names}
    todo = [n for n in names if not out[n].exists()]
    if not todo:
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        tmp = out[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    errors = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        out[n].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed on csrc/{n}.cu (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out[n])  # atomic: a concurrent loader sees all or nothing
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and load it (once per process)."""
    return ctypes.CDLL(str(build([name])[name]))
