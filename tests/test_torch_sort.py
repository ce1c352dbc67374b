"""The port's u32 sort against the reference's ``pallas_sort.sort_u32``.

The reference runs through ``force_xla=True`` (``lax.sort``), its own
path off the TPU: its Pallas kernel does not trace in interpret mode with
the installed jax, which refuses the captured ``_SIGN`` constant
(pallas_sort.py:92).  The port's ``sort_u32`` takes its plain version,
``sort_u32_ref``, for CPU tensors.  Inputs are made with numpy from a seed:
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


@pytest.mark.parametrize("shape,npay", [((2, 1000), 0), ((2, 3072), 0),
                                        ((2, 1024), 5)])
def test_sort_rejects_what_the_kernel_cannot_take(shape, npay):
    keys = torch.zeros(shape, dtype=torch.int32)
    with pytest.raises(ValueError):
        S.sort_u32(keys, *[keys] * npay)
