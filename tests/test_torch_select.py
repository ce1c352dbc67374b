"""Candidate select of the port (ops/select.py) against the reference.

The same hash-sorted records, sorted with numpy, go through the port's
plain torch version, the reference Pallas kernel in interpret mode and the
reference XLA branch (read back through ``find_candidates(use_pallas=
False)``); the int32 distances must be identical.  The position-order plain
version must equal the reference's candidates.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qatzip_tpu.ops import match_finder as rmf
from qatzip_tpu.ops import pallas_select
from qatzip_tpu_torch.ops import select as S

torch.set_num_threads(1)

N = 4096
KINDS = ("text", "constant", "iterative", "random")


def _blocks(corpus_factory):
    datas = [corpus_factory(s, k) for k, s in zip(KINDS, (N, N, 3000, N))]
    arr = np.zeros((len(datas), N + 8), np.uint8)
    lens = np.zeros(len(datas), np.int32)
    for i, d in enumerate(datas):
        arr[i, :len(d)] = np.frombuffer(d, np.uint8)
        lens[i] = len(d)
    return arr, lens


def _numpy_sorted(arr, lens):
    """Keys and prefix words of match_finder.py:91-125, sorted with numpy's
    stable argsort.  Returns u32 (sk, sb4, sb4b)."""
    d = arr.astype(np.uint64)
    b4 = d[:, 0:N] | (d[:, 1:N + 1] << 8) | (d[:, 2:N + 2] << 16) \
        | (d[:, 3:N + 3] << 24)
    b4b = np.concatenate([b4[:, 4:], np.zeros((len(arr), 4), np.uint64)], 1)
    h = (((b4 & 0xFFFFFF) * 2654435761) & 0xFFFFFFFF) >> 17
    pos = np.arange(N, dtype=np.uint64)[None, :]
    valid = pos + 2 < lens[:, None].astype(np.uint64)
    key1 = np.where(valid, (h << 16) | pos, 0xFFFFFFFF)
    order = np.argsort(key1, axis=1, kind="stable")
    take = lambda a: np.take_along_axis(a, order, 1).astype(np.uint32)  # noqa: E731
    return take(key1), take(b4), take(b4b)


@pytest.mark.parametrize("depth", [4, 8, 16])
def test_select_ref_matches_pallas_and_xla(corpus_factory, depth):
    arr, lens = _blocks(corpus_factory)
    sk, sb4, sb4b = _numpy_sorted(arr, lens)
    got = S.select_candidates(
        *(torch.from_numpy(a.view(np.int32)) for a in (sk, sb4, sb4b)),
        depth).numpy()

    pallas = np.asarray(pallas_select.select_candidates(
        jnp.asarray(sk), jnp.asarray(sb4), jnp.asarray(sb4b), depth,
        interpret=True))
    assert (got == pallas).all()

    # the XLA branch, read back from the reference entry point: record i's
    # distance sits at its position, invalid records carry 0
    full = np.asarray(rmf.find_candidates(
        jnp.asarray(arr), jnp.asarray(lens), depth, use_pallas=False,
        stride=1, rank8=True)).astype(np.int32)
    ok = sk != 0xFFFFFFFF
    pos = (sk & 0xFFFF).astype(np.int64)
    xla = np.where(ok, np.take_along_axis(full, np.where(ok, pos, 0), 1), 0)
    assert (got == xla).all()
    assert (got > 0).sum() > N  # candidates were found


def test_select_rejects_mismatched_inputs():
    a = torch.zeros((2, 256), dtype=torch.int32)
    with pytest.raises(ValueError):
        S.select_candidates(a, a.to(torch.int64), a, 4)
    with pytest.raises(ValueError):
        S.select_candidates(a, a[:, :128], a, 4)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("depth", [8, 16])
def test_select_to_positions_ref_matches_reference(corpus_factory, depth,
                                                   stride):
    from qatzip_tpu_torch.ops import match_finder as mf

    arr, lens = _blocks(corpus_factory)
    sk, sb4, sb4b = mf.sorted_records(torch.from_numpy(arr),
                                      torch.from_numpy(lens), stride, True)
    got = S.select_to_positions_ref(sk, sb4, sb4b, depth, N)
    assert got.dtype == torch.uint16 and got.shape == (len(arr), N)
    want = np.asarray(rmf.find_candidates(
        jnp.asarray(arr), jnp.asarray(lens), depth, use_pallas=False,
        stride=stride, rank8=True))
    assert (got.numpy() == want).all()
    assert (want > 0).sum() > N // stride
    # the CPU wrapper is the plain version, at any depth
    assert torch.equal(S.select_to_positions(sk, sb4, sb4b, depth, N), got)
    assert torch.equal(S.select_to_positions(sk, sb4, sb4b, 5, N),
                       S.select_to_positions_ref(sk, sb4, sb4b, 5, N))


def test_select_to_positions_rejects_mismatched_inputs():
    a = torch.zeros((2, 256), dtype=torch.int32)
    with pytest.raises(ValueError):
        S.select_to_positions(a, a.to(torch.int64), a, 8, 512)
    with pytest.raises(ValueError):
        S.select_to_positions(a, a, a[:, :128], 8, 512)
