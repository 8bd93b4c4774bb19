"""Build the port's CUDA source with ``nvcc`` and load it with ctypes.

``csrc/pattern_spmm.cu`` compiles on first use into a shared library
with a plain C interface, under ``build/repro_torch_kernels/`` at the
repository root.  The file name carries a hash of the source and the
flags, so an edited source rebuilds and an unchanged one is reused.
There is no fallback: without ``nvcc`` the build raises, and so does
every kernel launch that needs it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["NVCC_FLAGS", "build", "build_dir", "find_nvcc", "load_library"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "pattern_spmm.cu"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def build_dir() -> Path:
    """``build/repro_torch_kernels`` at the repository root."""
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def find_nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else under ``$CUDA_HOME/bin`` or the
    toolkit's default prefix.  Raises when there is none."""
    candidates = [shutil.which("nvcc")]
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home:
            candidates.append(os.path.join(home, "bin", "nvcc"))
    for cand in candidates:
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels are built from source at first use"
    )


def build() -> Path:
    """Compile ``SOURCE`` unless an up-to-date library exists.

    Returns the library's path.  The compiler's report (``-Xptxas -v``:
    registers, shared memory, spills per kernel) is kept beside it with
    the suffix ``.log``.
    """
    src = SOURCE
    digest = hashlib.sha256(
        " ".join(NVCC_FLAGS).encode() + b"\0" + src.read_bytes()
    ).hexdigest()[:16]
    out_dir = build_dir()
    lib = out_dir / f"lib{src.stem}-{digest}.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".{lib.name}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed on {src.name} (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    return lib


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the library, with every entry point's
    argument and return types declared."""
    lib = ctypes.CDLL(str(build()))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.pattern_spmm_f32.argtypes = [ptr] * 5 + [i32] * 7 + [ptr]
    lib.pattern_spmm_f32.restype = i32
    lib.pattern_spmm_i8.argtypes = [ptr] * 6 + [i32] * 7 + [ptr]
    lib.pattern_spmm_i8.restype = i32
    return lib
