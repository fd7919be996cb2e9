"""crucible_tpu_torch.utils.rng against crucible_tpu.utils.rng: the PCG4D
streams must be bit-identical, since every random number of a render is
drawn from them."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crucible_tpu.utils import rng as jrng
from crucible_tpu_torch.utils import rng as trng
from tests.torch_threads import one_torch_thread  # noqa: F401

U32_MAX = 2**32 - 1


def _counters(seed: int, n: int = 4096) -> np.ndarray:
    """(4, n) uint32 counter tuples from numpy, with the extremes mixed in."""
    g = np.random.default_rng(seed)
    a = g.integers(0, 2**32, size=(4, n), dtype=np.uint64).astype(np.uint32)
    a[:, 0] = 0
    a[:, 1] = U32_MAX
    a[:, 2] = (0, U32_MAX, 0, U32_MAX)
    a[:, 3] = (U32_MAX, 0, 1, 2**31)
    return a


def _port(a: np.ndarray, dtype=np.int64):
    return [torch.from_numpy(c.astype(dtype)) for c in a]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pcg4d_bit_equal(seed):
    a = _counters(seed)
    want = jrng.pcg4d(*(jnp.asarray(c) for c in a))
    got = trng.pcg4d(*_port(a))
    for w, g in zip(want, got):
        assert g.dtype == torch.int64
        assert int(g.min()) >= 0 and int(g.max()) <= U32_MAX
        np.testing.assert_array_equal(g.numpy().astype(np.uint32), np.asarray(w))


def test_pcg4d_reads_int32_as_its_bit_pattern():
    a = _counters(3)
    as_u32 = trng.pcg4d(*_port(a))
    as_i32 = trng.pcg4d(*(torch.from_numpy(c.view(np.int32)) for c in a))
    for x, y in zip(as_u32, as_i32):
        assert torch.equal(x, y)


def test_pcg4d_broadcasts_python_ints():
    a = _counters(4)
    want = jrng.pcg4d(jnp.asarray(a[0]), 5, 3, U32_MAX)
    got = trng.pcg4d(torch.from_numpy(a[0].astype(np.int64)), 5, 3, U32_MAX)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy().astype(np.uint32), np.asarray(w))


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_uniform_bit_equal(k):
    a = _counters(10 + k)
    want = getattr(jrng, f"uniform{k}")(*(jnp.asarray(c) for c in a))
    got = getattr(trng, f"uniform{k}")(*_port(a))
    if k == 1:
        want, got = (want,), (got,)
    assert len(got) == k
    for w, g in zip(want, got):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_unit_float_is_top_24_bits():
    u = torch.tensor([0, 255, 256, U32_MAX, 2**31], dtype=torch.int64)
    f = trng._to_unit_float(u)
    assert f.tolist() == [0.0, 0.0, 2.0**-24, 1.0 - 2.0**-24, 0.5]
    assert float(f.max()) < 1.0


def test_stream_ids_match():
    for name in ("STREAM_TIME", "STREAM_PIXEL_JITTER", "STREAM_BOUNCE_BASE",
                 "STREAMS_PER_BOUNCE"):
        assert getattr(trng, name) == getattr(jrng, name), name
