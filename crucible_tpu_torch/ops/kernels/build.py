"""Build and load the port's CUDA kernels (``crucible_tpu_torch/csrc``).

Every ``csrc/*.cu`` file is compiled by ``nvcc`` into one shared library
with a plain C interface, which is loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -shared -Xcompiler -fPIC -o libcrucible_kernels.so csrc/*.cu

The library goes to ``build/crucible_tpu_torch/<hash>/`` beside the
package, keyed by a hash of the sources and flags, and is built at first use.
``-fmad=false`` keeps multiply-adds uncontracted so that the kernels round
like their eager-torch versions; see the note in ``csrc/megakernel.cu``.
A missing or failing ``nvcc`` is an error: nothing falls back to eager torch.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "crucible_tpu_torch"
LIB_NAME = "libcrucible_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def sources() -> list[Path]:
    return sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")])


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.access(found, os.X_OK):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin): the "
            "CUDA kernels of crucible_tpu_torch cannot be built"
        )
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


@functools.cache
def build() -> tuple[Path, float, str]:
    """Compile the kernels if this source hash has no library yet.

    Returns (library path, seconds spent compiling, nvcc's output). A cached
    library reports 0 seconds and an empty log.
    """
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib, 0.0, ""
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = [str(s) for s in sources() if s.suffix == ".cu"]
    # Compile to a temporary name, then rename: a concurrent build never
    # sees a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, *cu],
        capture_output=True,
        text=True,
    )
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, lib)
    (out_dir / "nvcc.log").write_text(log)
    return lib, seconds, log


@functools.cache
def load() -> ctypes.CDLL:
    """Build if needed, load the library and declare its C signatures."""
    lib_path, _, _ = build()
    lib = ctypes.CDLL(str(lib_path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.crucible_megakernel_forward.argtypes = [p, p, p, p, p, i, i, f, p, p]
    lib.crucible_megakernel_forward.restype = i
    lib.crucible_megakernel_smem_bytes.argtypes = [i]
    lib.crucible_megakernel_smem_bytes.restype = i
    lib.crucible_cuda_error_string.argtypes = [i]
    lib.crucible_cuda_error_string.restype = ctypes.c_char_p
    return lib
