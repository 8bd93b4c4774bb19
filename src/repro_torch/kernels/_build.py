"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Every ``csrc/*.cu`` compiles on first use into one shared library with a
plain C interface, under ``build/repro_torch_kernels/`` at the repository
root: one ``nvcc -c`` per source, all started together, then one link.
The file name carries a hash of the sources and the flags, so an edited
source rebuilds and an unchanged set is reused.  There is no fallback:
without ``nvcc`` the build raises, and so does every kernel launch that
needs it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["NVCC_FLAGS", "build", "build_dir", "declare", "find_nvcc",
           "load_library"]

CSRC = Path(__file__).resolve().parent / "csrc"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH,
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def sources() -> list[Path]:
    """The CUDA sources the library is built from, in name order."""
    return sorted(CSRC.glob("*.cu"))


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


def _run(procs) -> str:
    """Wait for every ``(name, Popen)``; raise on the first failure."""
    logs, failed = [], None
    for name, proc in procs:
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0 and failed is None:
            failed = (name, proc.returncode, out)
    if failed is not None:
        name, code, out = failed
        raise RuntimeError(f"nvcc failed on {name} (exit {code}):\n{out}")
    return "".join(logs)


def build() -> Path:
    """Compile :func:`sources` unless an up-to-date library exists.

    Returns the library's path.  The compiler's report (``-Xptxas -v``:
    registers, shared memory, spills per kernel) is kept beside it with
    the suffix ``.log``.
    """
    srcs = sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in srcs:
        h.update(b"\0" + src.name.encode() + b"\0" + src.read_bytes())
    out_dir = build_dir()
    lib = out_dir / f"librepro_torch_kernels-{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{lib.stem}.{os.getpid()}"
    objs = [out_dir / f".{tag}.{src.stem}.o" for src in srcs]
    tmp = out_dir / f".{tag}.so.tmp"
    try:
        log = _run([
            (src.name, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for src, obj in zip(srcs, objs)
        ])
        log += _run([("link", subprocess.Popen(
            [nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))])
        lib.with_suffix(".log").write_text(log)
        os.replace(tmp, lib)  # atomic: a concurrent loader sees all or nothing
    finally:
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    return lib


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the library, with every entry point's
    argument and return types declared."""
    return declare(ctypes.CDLL(str(build())))


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the argument and return types of every entry point ``lib``
    has (a library built from some of the sources has only theirs)."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    flash = ([ptr] * 4 + [i32] * 7 + [ctypes.c_longlong] * 12
             + [ctypes.c_float] + [i32] * 4 + [ptr])
    sigs = {
        "pattern_spmm_f32": [ptr] * 6 + [i32] * 10 + [ptr],
        "pattern_spmm_i8": [ptr] * 7 + [i32] * 10 + [ptr],
        "ou_mvm_f32": [ptr] * 3 + [i32] * 5 + [ptr],
        "flash_attention_fwd": flash,
        "flash_attention_fwd_mma": flash,
    }
    for name, argtypes in sigs.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, i32
    return lib
