"""The native BVH builder (``bvh_builder.cpp``), loaded with ``ctypes``.

``ops.bvh.build_bvh`` routes its median and SAH builds here by default;
the Python builder stays beside it as the plain version, and both give the
same trees bit for bit. The library is compiled at first use into
``build/crucible_tpu_torch/<hash>/libbvh_builder.so`` beside the package,
keyed by a hash of the source, the compiler and its flags:

    g++ -O2 -shared -fPIC -ffp-contract=off -o libbvh_builder.so bvh_builder.cpp

(``-ffp-contract=off`` keeps every multiply and add rounded on its own, as
numpy rounds them in the Python builder.) A missing compiler or a failed
build raises ``RuntimeError`` naming the compiler and the command: nothing
falls back to the Python builder.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from crucible_tpu_torch.ops.kernels.build import BUILD_ROOT

SOURCE = Path(__file__).resolve().parent / "bvh_builder.cpp"
CXX = "g++"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-ffp-contract=off")
ENTRY_POINTS = {"median": "crucible_build_bvh", "sah": "crucible_build_bvh_sah"}

_F32P = ctypes.POINTER(ctypes.c_float)
_I32P = ctypes.POINTER(ctypes.c_int32)
# bb_min, bb_max, m, leaf_size, node_min, node_max, node_first, node_count,
# node_miss, node_parent, perm -> nodes written, or -1
_ARGTYPES = [_F32P, _F32P, ctypes.c_int64, ctypes.c_int64, _F32P, _F32P,
             _I32P, _I32P, _I32P, _I32P, _I32P]


def library_path() -> Path:
    """Where this source, compiler and flags build the library."""
    h = hashlib.sha256(" ".join((CXX, *CXX_FLAGS)).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libbvh_builder.so"


def _compile(out: Path) -> None:
    cxx = shutil.which(CXX)
    cmd = [CXX, *CXX_FLAGS, "-o", str(out), str(SOURCE)]
    if cxx is None:
        raise RuntimeError(
            f"the native BVH builder needs the C++ compiler {CXX!r}, which is not "
            f"on PATH; it is built with: {' '.join(cmd)}"
        )
    out.parent.mkdir(parents=True, exist_ok=True)
    # Compile to a temporary name, then rename: a concurrent build never
    # loads a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(
                f"building the native BVH builder failed ({CXX} exited "
                f"{proc.returncode}): {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


@functools.cache
def load() -> ctypes.CDLL:
    """Build the library if this source has none yet, load it and declare
    its C signatures."""
    path = library_path()
    if not path.exists():
        _compile(path)
    lib = ctypes.CDLL(str(path))
    for name in ENTRY_POINTS.values():
        fn = getattr(lib, name)
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int64
    return lib


def build_bvh(bb_min: np.ndarray, bb_max: np.ndarray, leaf_size: int,
              method: str) -> dict:
    """The C++ build over M primitive boxes (``bb_min``, ``bb_max`` (M, 3))
    -> ``ops.bvh.FlatBVH``'s fields as a dict of numpy arrays."""
    if method not in ENTRY_POINTS:
        raise ValueError(f"unknown BVH split method {method!r}")
    bb_min = np.ascontiguousarray(bb_min, np.float32)
    bb_max = np.ascontiguousarray(bb_max, np.float32)
    m = len(bb_min)
    if m == 0 or bb_min.shape != (m, 3) or bb_max.shape != (m, 3):
        raise ValueError(f"boxes must be (M, 3) with M > 0, got {bb_min.shape} "
                         f"and {bb_max.shape}")
    if leaf_size < 1:
        raise ValueError(f"leaf_size must be positive, got {leaf_size}")
    cap = 4 * m + 2  # the builder's capacity for any split sequence
    out = dict(
        node_min=np.empty((cap, 3), np.float32), node_max=np.empty((cap, 3), np.float32),
        node_first=np.empty(cap, np.int32), node_count=np.empty(cap, np.int32),
        node_miss=np.empty(cap, np.int32), node_parent=np.empty(cap, np.int32),
    )
    perm = np.empty(m, np.int32)

    def ptr(a):
        return a.ctypes.data_as(_F32P if a.dtype == np.float32 else _I32P)

    fn = getattr(load(), ENTRY_POINTS[method])
    k = fn(ptr(bb_min), ptr(bb_max), m, int(leaf_size), *(ptr(a) for a in out.values()),
           ptr(perm))
    if k < 0:
        raise RuntimeError(f"the native {method} build of {m} boxes overran its "
                           f"{cap} nodes")
    return {**{key: a[:k].copy() for key, a in out.items()}, "perm": perm}
