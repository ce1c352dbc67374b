"""The port's match finder (ops/match_finder.py) against the reference.

On the four conftest corpus kinds at n = 4096, the port's uint16
candidates must equal the reference's ``find_candidates(use_pallas=False)``
for every depth, stride and rank8 setting the knobs reach, and the native
parser (shared by both) must turn them into a stream zlib inflates back.
The packed candidate format must equal the reference's byte for byte.
"""
import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from qatzip_tpu.native import qzcore as native
from qatzip_tpu.ops import match_finder as rmf
from qatzip_tpu_torch.ops import match_finder as mf

torch.set_num_threads(1)

N = 4096


def _batch(corpus_factory):
    """One block per corpus kind, with a short and an empty block."""
    datas = [corpus_factory(N, k)
             for k in ("text", "constant", "random", "iterative")]
    datas += [corpus_factory(1000, "text"), b""]
    arr = np.zeros((len(datas), N + 8), np.uint8)
    lens = np.zeros(len(datas), np.int32)
    for i, d in enumerate(datas):
        arr[i, :len(d)] = np.frombuffer(d, np.uint8)
        lens[i] = len(d)
    return datas, arr, lens


@pytest.mark.parametrize("rank8", [True, False])
@pytest.mark.parametrize("stride", [1, 2, 3])
@pytest.mark.parametrize("depth", [4, 8, 16])
def test_candidates_match_reference(corpus_factory, depth, stride, rank8):
    datas, arr, lens = _batch(corpus_factory)
    want = np.asarray(rmf.find_candidates(
        jnp.asarray(arr), jnp.asarray(lens), depth, use_pallas=False,
        stride=stride, rank8=rank8))
    got = mf.find_candidates(torch.from_numpy(arr), torch.from_numpy(lens),
                             depth, stride=stride, rank8=rank8)
    assert got.dtype == torch.uint16
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert (got == want).all()
    assert (got[0] > 0).any()
    for i, d in enumerate(datas):
        payload = native.deflate_candidates(d, got[i], 1)
        assert zlib.decompress(payload, -15) == d


def test_knobs_read_the_reference_env_names(corpus_factory, monkeypatch):
    datas, arr, lens = _batch(corpus_factory)
    monkeypatch.setenv("QATZIP_TPU_MF_STRIDE", "2")
    monkeypatch.setenv("QATZIP_TPU_MF_RANK8", "0")
    args = (torch.from_numpy(arr), torch.from_numpy(lens), 8)
    assert torch.equal(mf.find_candidates(*args),
                       mf.find_candidates(*args, stride=2, rank8=False))
    assert not torch.equal(mf.find_candidates(*args),
                           mf.find_candidates(*args, stride=1, rank8=True))


@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("kind", ["text", "random", "constant"])
def test_packed_candidates_match_reference(corpus_factory, kind, depth):
    """u8 [B, 3n/4] equal to the reference's _find_candidates_packed_impl
    (its XLA path, stride 1), and the port's native unpacker turns them into
    a stream zlib inflates back."""
    from qatzip_tpu_torch.native import qzcore as tnative

    datas = [corpus_factory(N, kind), corpus_factory(3000, kind), b""]
    arr = np.zeros((len(datas), N + 8), np.uint8)
    lens = np.zeros(len(datas), np.int32)
    for i, d in enumerate(datas):
        arr[i, :len(d)] = np.frombuffer(d, np.uint8)
        lens[i] = len(d)
    want = np.asarray(rmf._find_candidates_packed_impl(
        jnp.asarray(arr), jnp.asarray(lens), depth, False, 1))
    got = mf.find_candidates_packed(torch.from_numpy(arr),
                                    torch.from_numpy(lens), depth)
    assert got.dtype == torch.uint8 and got.shape == (len(datas), 3 * N // 4)
    assert (got.numpy() == want).all()
    for i, d in enumerate(datas):
        payload = tnative.deflate_candidates_packed(d, got[i].numpy(), 1)
        assert payload == native.deflate_candidates_packed(d, want[i], 1)
        assert zlib.decompress(payload, -15) == d


def test_packed_candidates_refuse_widths_off_the_chunk_grid():
    data = torch.zeros((1, 1000 + 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="multiple of 64"):
        mf.find_candidates_packed(data, torch.tensor([1000],
                                                     dtype=torch.int32))
