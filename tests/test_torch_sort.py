"""The port's u32 sort against the reference's ``pallas_sort.sort_u32``.

The reference runs through ``force_xla=True`` (``lax.sort``), its own
path off the TPU: its Pallas kernel does not trace in interpret mode with
the installed jax, which refuses the captured ``_SIGN`` constant
(pallas_sort.py:92).  The port's ``sort_u32`` takes its plain version,
``sort_u32_ref``, for CPU tensors of any shape; the kernel's limits apply
to CUDA tensors only.  Inputs are made with numpy from a seed:
unique u32 keys, with high bits set, when payloads are passed, and keys
with ties when none are.
"""
import numpy as np
import pytest
import torch

from qatzip_tpu.ops import pallas_sort as rps
from qatzip_tpu_torch.ops import sort as S


def _inputs(n: int, npay: int, seed: int):
    rng = np.random.default_rng(seed)
    if npay:
        pool = np.unique(rng.integers(0, 1 << 32, 4 * n, dtype=np.uint64))
        keys = rng.permutation(pool)[:2 * n].astype(np.uint32)
    else:
        keys = (rng.integers(0, 64, 2 * n, dtype=np.uint64) * 0x05F5E1
                + (1 << 31)).astype(np.uint32)
    pays = [rng.integers(0, 1 << 32, 2 * n, dtype=np.uint64).astype(np.uint32)
            for _ in range(npay)]
    return [a.reshape(2, n) for a in (keys, *pays)]


@pytest.mark.parametrize("npay", [0, 1, 2])
@pytest.mark.parametrize("n", [1024, 4096])
def test_sort_equals_reference(n, npay):
    import jax.numpy as jnp

    arrs = _inputs(n, npay, seed=n + npay)
    want = rps.sort_u32(*(jnp.asarray(a) for a in arrs), force_xla=True)
    got = S.sort_u32(*(torch.from_numpy(a.view(np.int32)) for a in arrs))
    assert len(got) == len(want) == 1 + npay
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy().view(np.uint32), np.asarray(w))
    assert (np.diff(got[0].numpy().view(np.uint32).astype(np.int64))
            >= 0).all()


@pytest.mark.parametrize("n,npay", [(1000, 0), (3072, 2), (1024, 5)])
def test_sort_on_the_cpu_takes_any_shape_as_the_reference(n, npay):
    """Shapes and payload counts the kernel does not take: on CPU tensors
    the port sorts them as the reference's lax.sort path does."""
    import jax.numpy as jnp

    arrs = _inputs(n, npay, seed=7 * n + npay)
    want = rps.sort_u32(*(jnp.asarray(a) for a in arrs), force_xla=True)
    got = S.sort_u32(*(torch.from_numpy(a.view(np.int32)) for a in arrs))
    assert len(got) == len(want) == 1 + npay
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy().view(np.uint32), np.asarray(w))


def test_timing_inputs_have_unique_keys_the_reference_sorts():
    """The card's sort inputs (tools/sort_bench.py, chip_smoke.py): keys
    unique in each row, across the u32 range, sorted as the reference
    sorts them."""
    import jax.numpy as jnp

    from qatzip_tpu_torch.tools import sort_bench

    t = sort_bench.inputs(2, 2048, 2, seed=3, dev="cpu")
    keys = t[0].numpy().view(np.uint32)
    assert all(len(np.unique(r)) == r.size for r in keys)
    assert (keys >= 1 << 31).any() and (keys < 1 << 31).any()
    want = rps.sort_u32(*(jnp.asarray(a.numpy().view(np.uint32)) for a in t),
                        force_xla=True)
    for g, w in zip(S.sort_u32(*t), want):
        assert np.array_equal(g.numpy().view(np.uint32), np.asarray(w))


@pytest.mark.parametrize("n,npay", [(1000, 0), (3072, 0), (1024, 5)])
def test_kernel_limits_reject_what_the_kernel_cannot_take(n, npay):
    with pytest.raises(ValueError):
        S.check_kernel_limits(n, npay)
    S.check_kernel_limits(1 << (n - 1).bit_length(), min(npay, 4))
