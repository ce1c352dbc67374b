"""The port's multi-device and multi-process layer against the reference,
on the CPU.

A mesh is a list of devices; here lists of ``torch.device("cpu")`` stand
in for the cards (the kernels' plain versions run on each).  Block-DP
must give the bytes of the one-device path: ``compress_blocks_sharded``
equals the unsharded encoder (and the reference's), each slice left on its
device; the public API with the mesh pinned equals the unpinned run; the
match finder's batch wrapper and a speculative round cut over the mesh
equal the uncut ones.  The collectives of parallel/dist.py run over a list
of devices and across two gloo ranks, and the multi-process cases of
tests/test_multiprocess.py run through the port's worker
(``python -m qatzip_tpu_torch.tools.dist_worker``), each with a time
limit after which both ranks are killed.
"""
import gzip
import os
import zlib

import numpy as np
import pytest
import torch


import qatzip_tpu_torch as qt
from qatzip_tpu import constants as C
from qatzip_tpu.constants import QzDataFormat
from qatzip_tpu.ops import deflate_encode as rde
from qatzip_tpu_torch.engine import core
from qatzip_tpu_torch.ops import deflate_decode as dd
from qatzip_tpu_torch.ops import deflate_encode as de
from qatzip_tpu_torch.parallel import dist, shard
from qatzip_tpu_torch.tools import dist_worker

torch.set_num_threads(1)

CPU = torch.device("cpu")
MESH4 = [CPU] * 4


@pytest.fixture
def pinned_mesh(monkeypatch):
    """Pin the local mesh (restored after the test)."""
    def pin(mesh):
        monkeypatch.setattr(shard, "_MESH", mesh)
    yield pin


@pytest.fixture
def cpu_engine(monkeypatch):
    monkeypatch.setenv("QATZIP_TPU_DEVICE", "1")
    core.qz_close_engine()
    assert qt.qz_init(qt.QzSession(), device=CPU) == C.QZ_OK
    yield core.engine()
    core.qz_close_engine()


# ------------------------------------------------------------------ shard
def test_block_slices_are_contiguous_and_cover_the_batch():
    assert shard.block_slices(7, None) is None
    assert shard.block_slices(7, MESH4) is None           # < 2 a device
    sl = shard.block_slices(11, MESH4)
    assert [(s, e) for _, s, e in sl] == [(0, 3), (3, 6), (6, 9), (9, 11)]
    assert shard.block_slices(8, [CPU]) == [(CPU, 0, 8)]


def test_make_mesh_and_local_mesh(monkeypatch):
    assert shard.make_mesh(2, [CPU] * 3) == [CPU, CPU]
    with pytest.raises(RuntimeError, match="need 4"):
        shard.make_mesh(4, [CPU] * 3)
    with pytest.raises(RuntimeError, match="CUDA devices"):
        shard.make_mesh(1)                    # no CUDA device here
    monkeypatch.setattr(shard, "_MESH", shard._MESH_UNSET)
    assert shard.local_mesh() is None         # below two CUDA devices


def test_sharded_compress_matches_single(corpus_factory):
    n, b = 4096, 16
    blob = corpus_factory(b * n)
    data = np.zeros((b, n + 8), np.uint8)
    data[:, :n] = np.frombuffer(blob, np.uint8).reshape(b, n)
    lens = np.full((b,), n, np.int32)

    words, bits, mode = shard.compress_blocks_sharded(MESH4, data, lens)
    assert len(words) == len(bits) == 4
    assert all(w.device == d and w.shape[0] == b // 4
               for w, d in zip(words, MESH4))
    w1, b1, m1 = de.encode_blocks(data, lens, 1, 16, True,
                                  de.words_bound(n), device=CPU)
    words, bits = shard.gather(words), shard.gather(bits)
    assert (words == w1.numpy()).all() and (bits == b1.numpy()).all()
    assert (mode == m1).all()
    rw, rb, rm = rde.encode_blocks(data, lens, 1, 16, True, de.words_bound(n))
    assert (words == np.asarray(rw)).all() and (mode == np.asarray(rm)).all()
    out = bytearray()
    for i in range(b):
        if mode[i] == de.MODE_STORED:
            out += blob[i * n:(i + 1) * n]
        else:
            payload = words[i].astype(np.uint32).tobytes()
            out += zlib.decompressobj(-15).decompress(
                payload[:(int(bits[i]) + 7) // 8])
    assert bytes(out) == blob


def test_sharded_compress_needs_a_multiple_of_the_mesh():
    data = np.zeros((6, 1032), np.uint8)
    with pytest.raises(ValueError, match="does not divide"):
        shard.compress_blocks_sharded(MESH4, data, np.full(6, 1024, np.int32))


def test_scaling_report_runs():
    rep = shard.scaling_report([CPU, CPU], block_bytes=1024,
                               blocks_per_device=2, reps=2)
    assert rep["devices"] == 2
    assert rep["mesh_Bps"] > 0 and rep["single_device_Bps"] > 0


def test_find_candidates_batch_over_mesh_equals_reference(corpus_factory):
    from qatzip_tpu.ops import match_finder as rmf
    from qatzip_tpu_torch.ops import match_finder as mf

    n, b = 2048, 8
    data = np.zeros((b, n + 8), np.uint8)
    for i in range(b):
        data[i, :n] = np.frombuffer(corpus_factory(n), np.uint8)
    lens = np.full(b, n, np.int32)
    lens[3] = 100
    got = mf.find_candidates_batch(data, lens, mesh=MESH4)
    assert (got == mf.find_candidates_batch(data, lens, device=CPU)).all()
    assert (got == np.asarray(rmf.find_candidates_batch(data, lens))).all()


def test_spec_round_over_mesh_equals_single(corpus_factory, monkeypatch,
                                            pinned_mesh):
    monkeypatch.setenv("QATZIP_TPU_INFLATE", "spec")
    datas = [corpus_factory(1500 + 300 * i, "text") for i in range(9)]
    payloads = [zlib.compress(d, 6)[2:-4] for d in datas]
    hints = [len(d) for d in datas]
    single = dd.inflate_batch(payloads, hints, CPU, kind="crc32")
    pinned_mesh(MESH4)
    assert dd.inflate_batch(payloads, hints, CPU, kind="crc32") == single
    assert [r[0] for r in single] == datas
    assert [r[2] for r in single] == [zlib.crc32(d) for d in datas]


@pytest.mark.parametrize("encoder", ["hybrid", "device"])
def test_public_api_with_pinned_mesh_equals_unpinned(corpus_factory,
                                                     monkeypatch, cpu_engine,
                                                     pinned_mesh, encoder):
    """A many-chunk request through the public API: the batch is cut over
    the pinned mesh, bytes equal to the unpinned run, round trip exact."""
    monkeypatch.setenv("QATZIP_TPU_ENCODER", encoder)
    data = corpus_factory(96 * 1024)
    fmt = QzDataFormat.QZ_DEFLATE_GZIP_EXT
    want = qt.compress(data, fmt=fmt, level=1, hw_buff_sz=4096)
    cuts = []
    real = shard.block_slices
    monkeypatch.setattr(shard, "block_slices",
                        lambda c, m: cuts.append(real(c, m)) or cuts[-1])
    pinned_mesh(MESH4)
    hw0, sw0 = cpu_engine.hw_requests, cpu_engine.sw_requests
    comp = qt.compress(data, fmt=fmt, level=1, hw_buff_sz=4096)
    assert comp == want
    assert cpu_engine.sw_requests == sw0
    assert cpu_engine.hw_requests - hw0 == 24
    assert any(c is not None and len(c) == 4 for c in cuts)
    assert gzip.decompress(comp) == data
    lz = qt.compress(data, "lz4", level=1, hw_buff_sz=4096)
    pinned_mesh(None)
    assert lz == qt.compress(data, "lz4", level=1, hw_buff_sz=4096)


# ------------------------------------------------------------------- dist
def test_init_distributed_noop_single_process(monkeypatch):
    for var in ("QATZIP_TPU_COORDINATOR", "JAX_COORDINATOR_ADDRESS",
                "QATZIP_TPU_NUM_PROCESSES", "JAX_NUM_PROCESSES"):
        monkeypatch.delenv(var, raising=False)
    assert dist.init_distributed() is False
    assert dist.process_info() == (0, 1)


def test_host_block_range_partition():
    assert dist.host_block_range(100) == (0, 100)  # one process owns all


def test_sharded_offsets_over_a_device_list():
    lengths = np.array([100, 7, 0, 31, 8, 255, 1, 64], np.int32)
    offs = dist.sharded_offsets(MESH4, lengths)
    assert len(offs) == 4 and all(o.device == CPU for o in offs)
    want = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    assert (np.concatenate([o.numpy() for o in offs]) == want).all()
    # one process: the ranks' form returns the whole window
    assert (dist.sharded_offsets(None, lengths).numpy() == want).all()


# --------------------------------------------- two processes (gloo, CPU)
def _ranks(args, force_sw="1"):
    env = dict(os.environ, QATZIP_TPU_FORCE_SW=force_sw)
    return dist_worker.launch(args, env=env, timeout=120)


def _expect(outs, *markers):
    """Every rank printed each marker, and DIST DONE: it passed the closing
    barrier and left its process group before it exited."""
    for rank, out in enumerate(outs):
        for m in (*markers, "DIST DONE"):
            assert m in out, f"rank {rank}: missing {m}\n{out[-2000:]}"


def test_two_process_distributed_roundtrip():
    _expect(_ranks([]), "DIST OK")


def test_two_process_distributed_lz4_frame():
    _expect(_ranks(["--lz4"]), "DIST OK", "DIST LZ4 OK")


def test_two_process_async_ring_coexists_with_collectives():
    _expect(_ranks(["--async"]), "DIST OK", "DIST ASYNC OK")


def test_two_process_device_kernel_path():
    """The device route under the process group, on the CPU device."""
    _expect(_ranks(["--device", "cpu"], force_sw="0"), "DIST OK",
            "DIST DEVICE OK")


def test_two_process_offsets_collectives():
    _expect(_ranks(["--offsets"]), "DIST OK", "DIST OFFSETS OK")


def test_launch_kills_ranks_past_the_time_limit():
    """Ranks still running at the launcher's time limit are killed and the
    launcher raises, so a hung rank cannot hang its caller."""
    with pytest.raises(RuntimeError, match="ran past"):
        dist_worker.launch([], env=dict(os.environ, QATZIP_TPU_FORCE_SW="1"),
                           timeout=1)


# ------------------------------------------------------------ graft entry
def test_entry_equals_reference():
    import __graft_entry__ as ref
    from qatzip_tpu_torch import graft_entry

    fn, args = graft_entry.entry(CPU)
    rfn, rargs = ref.entry()
    assert (fn(*args).numpy() == np.asarray(rfn(*rargs))).all()


def test_dryrun_multichip_on_two_cpu_devices(monkeypatch, capsys):
    from qatzip_tpu_torch import graft_entry

    monkeypatch.delenv("QATZIP_TPU_DEVICE", raising=False)
    core.qz_close_engine()
    try:
        graft_entry.dryrun_multichip(2, devices=[CPU, CPU])
    finally:
        core.qz_close_engine()
    out = capsys.readouterr().out
    assert "2-way block-DP" in out and out.count("oneshot+stream+async") == 14
    assert shard._MESH is shard._MESH_UNSET or shard._MESH is None
    assert "QATZIP_TPU_DEVICE" not in os.environ


def test_dryrun_multichip_refuses_missing_devices():
    from qatzip_tpu_torch import graft_entry

    with pytest.raises(RuntimeError, match="CUDA devices"):
        graft_entry.dryrun_multichip(1)
    with pytest.raises(RuntimeError, match="need 3"):
        graft_entry.dryrun_multichip(3, devices=[CPU, CPU])
