"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source is compiled at first use, one ``nvcc`` process
per source started together, and linked into a shared library with a
plain C interface under ``build/`` at the repository root, keyed by a hash
of every file a source can include (``csrc/*.cu`` and ``csrc/*.cuh``) and
of the compile and link flags: a changed source, header or flag builds a
new library; an unchanged tree reuses it.  The library is
loaded with :mod:`ctypes`: every pointer and the stream travel as
``c_void_p``, and every entry point returns ``cudaGetLastError()`` so a
refused launch raises here instead of vanishing.

Nothing here runs at import: the CPU tests import every module of the
package, and this machine may have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo",
)
LINK_FLAGS = ("-shared",)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
#: C signatures of the library's entry points (all return an int: a status,
#: or for ``*_smem_bytes`` a size)
SIGNATURES = {
    "nexus_flash_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P],
    "nexus_flash_fwd_smem_bytes": [_I],
    "nexus_flash_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P],
    "nexus_flash_bwd_dkv": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "nexus_flash_bwd_smem_bytes": [_I, _I],
    "nexus_decode_attention": [
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P,
    ],
    "nexus_decode_smem_bytes": [_I, _I, _I],
    "nexus_decode_ctas_per_sm": [_I, _I, _I],
    "nexus_quant_matmul": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "nexus_quant_int4_ring": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "nexus_quant_int4_ctas_per_sm": [],
    "nexus_quant_int4_smem_bytes": [],
    "nexus_gmm": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "nexus_tgmm": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "nexus_gmm_smem_bytes": [_I],
    "nexus_rms_norm": [_P, _P, _P, _I, _I, _I, _I, _F, _P],
}

_lock = threading.Lock()
_library: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
            "kernels are built on the machine with the card"
        )
    return found


def sources() -> list:
    found = sorted(CSRC.glob("*.cu"))
    if not found:
        raise RuntimeError(f"no CUDA sources under {CSRC}: run from a checkout of the repository")
    return found


def library_path() -> Path:
    """The library's path, named by a hash of the flags and of every file
    under ``csrc/`` that a source compiles or includes."""
    digest = hashlib.sha256(repr((NVCC_FLAGS, LINK_FLAGS)).encode())
    for src in sources() + sorted(CSRC.glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libnexus_kernels_{digest.hexdigest()[:16]}.so"


def _run(cmd: list) -> None:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
        )


def build() -> Path:
    """Compile the sources unless a library for exactly these sources
    exists; returns its path.  Each source compiles in its own ``nvcc``
    process, all started together (the build's time is that of the
    slowest source, not the sum), then one link makes the library.
    Raises with the compiler's output on failure, after every process
    has ended."""
    target = library_path()
    if not target.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{target.stem}.{os.getpid()}"
        objects, procs = [], []
        for src in sources():
            obj = BUILD_DIR / f"{tag}.{src.stem}.o"
            cmd = [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
            )))
            objects.append(obj)
        failures = []
        for cmd, proc in procs:
            out, err = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}\n{err}")
        if failures:
            raise RuntimeError("\n".join(failures))
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        _run([_nvcc(), *LINK_FLAGS, "-o", str(tmp), *map(str, objects)])
        for obj in objects:
            obj.unlink()
        os.replace(tmp, target)
    return target


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _library
    with _lock:
        if _library is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.nexus_error_string.argtypes = [ctypes.c_int]
            lib.nexus_error_string.restype = ctypes.c_char_p
            _library = lib
        return _library


def check(status: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if status != 0:
        msg = library().nexus_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")


def stream_ptr(device) -> int:
    """PyTorch's current stream on ``device``, as the int ctypes passes."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
