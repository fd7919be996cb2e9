"""Build and load the port's CUDA kernels (``crucible_tpu_torch/csrc``).

Each ``csrc/*.cu`` file is compiled by its own ``nvcc`` process into a
shared library with a plain C interface, which is loaded with ``ctypes``;
the processes start together, so the build takes as long as the slowest
file:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -shared -Xcompiler -fPIC -o lib<name>.so csrc/<name>.cu

The libraries go to ``build/crucible_tpu_torch/<hash>/`` beside the
package, keyed by a hash of the sources and flags, and are built at first
use. ``-fmad=false`` keeps multiply-adds uncontracted so that the kernels
round like their eager-torch versions; see the note in
``csrc/megakernel.cu``. A missing or failing ``nvcc`` is an error: nothing
falls back to eager torch.
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

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "crucible_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures of each library's entry points: name -> (argtypes, restype).
SIGNATURES = {
    "megakernel": {
        "crucible_megakernel_forward": ([_P] * 16 + [_I] * 5 + [_F, _I, _I, _P, _P], _I),
        "crucible_megakernel_record": ([_P] * 16 + [_I] * 6 + [_F, _I, _I, _I] + [_P] * 3, _I),
        "crucible_megakernel_flat_shape": ([_I] * 7 + [ctypes.POINTER(_I)], _I),
        "crucible_cuda_error_string": ([_I], ctypes.c_char_p),
    },
    "replay_kernel": {
        "crucible_replay_forward": ([_P] * 7 + [_I] * 6 + [_P] * 3, _I),
        "crucible_replay_backward": ([_P] * 8 + [_I] * 7 + [_P] * 6, _I),
        "crucible_replay_legacy_forward": ([_P] * 7 + [_I] * 6 + [_P] * 3, _I),
        "crucible_replay_legacy_backward": ([_P] * 8 + [_I] * 7 + [_P] * 6, _I),
        "crucible_replay_shape": ([_I, _I, ctypes.POINTER(_I)], _I),
        "crucible_cuda_error_string": ([_I], ctypes.c_char_p),
    },
    "sphere_hit": {
        "crucible_sphere_hit": ([_P] * 5 + [_I, _I, _F, _I] + [_P] * 3, _I),
        "crucible_sphere_hit_shape": ([_I, ctypes.POINTER(_I)], _I),
        "crucible_cuda_error_string": ([_I], ctypes.c_char_p),
    },
    "sphere_shade": {
        "crucible_sphere_shade": ([_P] * 4 + [_I, _I, _F, _I] + [_P] * 2, _I),
        "crucible_sphere_shade_shape": ([_I, ctypes.POINTER(_I)], _I),
        "crucible_cuda_error_string": ([_I], ctypes.c_char_p),
    },
}


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
def build() -> tuple[dict[str, Path], float, str]:
    """Compile every ``.cu`` whose library this source hash lacks, one
    ``nvcc`` process per file, all at once.

    Returns ({stem: library path}, seconds spent compiling, nvcc's output).
    Cached libraries report 0 seconds and an empty log.
    """
    out_dir = BUILD_ROOT / _digest()
    libs = {s.stem: out_dir / f"lib{s.stem}.so" for s in sources() if s.suffix == ".cu"}
    todo = {stem: lib for stem, lib in libs.items() if not lib.exists()}
    if not todo:
        return libs, 0.0, ""
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for stem in todo:
        # Compile to a temporary name, then rename: a concurrent build
        # never sees a half-written library.
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{stem}.cu")]
        procs[stem] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    logs, failed = [], []
    for stem, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs.append(f"--- {stem}.cu\n{out}")
        if proc.returncode != 0:
            failed.append(stem)
            os.unlink(tmp)
        else:
            os.replace(tmp, todo[stem])
    seconds = time.perf_counter() - t0
    log = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n{log}")
    (out_dir / "nvcc.log").write_text(log)
    return libs, seconds, log


@functools.cache
def load(stem: str) -> ctypes.CDLL:
    """Build if needed, load ``lib<stem>.so`` and declare its C signatures."""
    libs, _, _ = build()
    lib = ctypes.CDLL(str(libs[stem]))
    for name, (argtypes, restype) in SIGNATURES[stem].items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def check_tensors(device: torch.device, expect) -> None:
    """Validate a wrapper's inputs: ``expect`` holds (name, tensor, dtype,
    shape or None) entries; each must be a contiguous tensor of that dtype
    and shape on ``device``, which must be the CPU or a CUDA card."""
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    for name, x, dtype, shape in expect:
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(x).__name__}")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if shape is not None and tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, not {device}")


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = lib.crucible_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({err})")
