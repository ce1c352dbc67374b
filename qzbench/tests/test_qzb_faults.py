"""What decides ``correct``, driven through whole runs on the CPU at small
sizes (the card's look skipped): a request that ran any part off the
device route counts as failed; the control (the reference in the
program's place, one guarantee broken) comes out not correct; and so does
the program with each fault a cell can have planted in its timed path."""
import copy
import json
import os
import time
import types

import pytest
import torch

from qzbench import control, harness

CPU = torch.device("cpu")
GZC, GZD = "gzipext_l1.compress_128m_c4", "gzipext_l1.decompress_32m_c4"
L4C, L4D = "lz4_l1.compress_c4", "lz4_l1.decompress_32m_c4"
CELLS = [GZC, GZD, L4D, L4C]


def _bench():
    """BENCHMARK.json, and the cells of the LZ4 configuration, whose files
    the benchmark keeps though its cells are not yet in it."""
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "lz4_l1",
                             "file": "qzbench/configs/lz4_l1.json"})
    bench["workloads"] += [
        {"name": L4C, "config": "lz4_l1", "traffic": "compress_c4",
         "chips": 1},
        {"name": L4D, "config": "lz4_l1", "traffic": "decompress_32m_c4",
         "chips": 1}]
    return bench


def small(name):
    """The cell at a size the CPU's plain kernels finish quickly."""
    cell = harness.Cell(_bench(), name)
    gz_dec = name == GZD
    chunk = 4096 if gz_dec else 65536
    cell.traffic = dict(cell.traffic, clients=1 if gz_dec else 2,
                        request_bytes=2 * chunk)
    cell.config = copy.deepcopy(cell.config)
    cell.config["chunk_bytes"] = chunk
    cell.config["session"]["common"]["hw_buff_sz"] = chunk
    return cell


def run(cell, serve=None, seed=2**31 + 17):
    result, _ = harness.run_cell(cell, seed, 0.01, False,
                                 time.perf_counter(), device=CPU,
                                 serve=serve)
    return result


def _ok(data, src):
    return types.SimpleNamespace(rc=0, data=data, consumed=len(src),
                                 ext_rc=0)


def reference_serve(cell):
    ref, chunk = cell.reference, cell.config["chunk_bytes"]

    def serve(direction, client, src):
        if direction == "compress":
            return _ok(ref.make(bytes(src), chunk), src)
        return _ok(ref.read(src), src)

    return serve


@pytest.mark.parametrize("name", [GZC, L4D])
def test_the_reference_in_the_program_place_is_correct(name):
    cell = small(name)
    res = run(cell, reference_serve(cell))
    assert res["correct"] and res["attempted"] >= 2 and res["failed"] == 0


@pytest.mark.parametrize("counter", ["failover_lanes", "failover_blocks",
                                     "sw_requests", "total_failures",
                                     "ext_rc"])
def test_a_request_off_the_device_route_is_failed(counter):
    from qatzip_tpu_torch import constants
    from qatzip_tpu_torch.engine import core, health
    from qatzip_tpu_torch.ops import deflate_decode, lz4_decode

    cell = small(GZC)
    good = reference_serve(cell)
    where = {"failover_lanes": deflate_decode, "failover_blocks": lz4_decode,
             "sw_requests": core._engine,
             "total_failures": health.health}

    def serve(direction, client, src):
        res = good(direction, client, src)
        if counter == "ext_rc":
            res.ext_rc = constants.QZ_SW_EXECUTION_MASK
        else:
            obj = where[counter]
            setattr(obj, counter, getattr(obj, counter) + 1)
        return res

    res = run(cell, serve)
    assert not res["correct"]
    assert res["failed"] == res["attempted"] > 0
    assert res["checks"]["failed_requests"]["value"] == res["failed"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    cell = small(name)
    res = run(cell, control.serve_control(cell))
    assert not res["correct"]
    assert res["checks"]["wrong_outputs"]["value"] > 0 or \
        res["checks"]["warmup_failed_or_wrong"]["value"] > 0


def _flip(b: bytes) -> bytes:
    b = bytearray(b)
    b[len(b) // 2] ^= 0x20
    return bytes(b)


def _fault(monkeypatch, kind, direction):
    """Plant one fault in the program's timed path."""
    from qatzip_tpu_torch.api import core
    from qatzip_tpu_torch.engine.core import OpResult
    from qatzip_tpu_torch.native import qzcore
    from qatzip_tpu_torch.ops import deflate_decode, device_codecs, lz4_decode

    if kind == "state_unchanged":
        # the request's step hands back what it was given
        name = "compress_ext" if direction == "compress" else "decompress_ext"
        monkeypatch.setattr(core, name, lambda sess, src, *a, **k: OpResult(
            data=bytes(src), consumed=len(src)))
    elif kind == "half_the_batch":
        if direction == "compress":
            real = device_codecs._map_chunks
            monkeypatch.setattr(
                device_codecs, "_map_chunks",
                lambda fn, items: real(fn, items[:len(items) // 2 or 1]))
        else:
            # every other stream's device rounds, every other block's
            # decode skipped
            real_round = deflate_decode._run_device_round
            monkeypatch.setattr(
                deflate_decode, "_run_device_round",
                lambda batch, dev: real_round(
                    [s for s in batch if s.index % 2 == 0], dev))
            real_impl = lz4_decode._decode_blocks_impl

            def impl(*a, **k):
                out, tot, err = real_impl(*a, **k)
                err = err.clone()
                err[1::2] = True
                return out, tot, err

            monkeypatch.setattr(lz4_decode, "_decode_blocks_impl", impl)
    else:   # an answer altered where it is produced
        if direction == "compress":
            for fn in ("deflate_candidates", "lz4_candidates"):
                real_fn = getattr(qzcore, fn)
                monkeypatch.setattr(qzcore, fn, lambda *a, _r=real_fn, **k:
                                    _flip(_r(*a, **k)))
        else:
            real_i = deflate_decode.inflate_batch

            def inflate(*a, **k):
                out = real_i(*a, **k)
                d, eof, crc = out[0]
                return [(_flip(d), eof, crc)] + out[1:]

            real_l = lz4_decode.decode_blocks

            def lz4(*a, **k):
                out = real_l(*a, **k)
                return [_flip(out[0])] + out[1:]

            monkeypatch.setattr(deflate_decode, "inflate_batch", inflate)
            monkeypatch.setattr(lz4_decode, "decode_blocks", lz4)


@pytest.mark.parametrize("kind", ["state_unchanged", "half_the_batch",
                                  "answer_altered"])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(name, kind, monkeypatch):
    cell = small(name)
    clean = run(cell)
    assert clean["correct"], clean["checks"]
    _fault(monkeypatch, kind, cell.direction)
    res = run(cell)
    assert not res["correct"], (kind, res["checks"])


@pytest.mark.parametrize("name", [GZC, GZD])
def test_a_traced_run_reads_the_set_up_layers(name):
    cell = small(name)
    result, _ = harness.run_cell(cell, 2**31 + 23, 0.01, True,
                                 time.perf_counter(), device=CPU,
                                 serve=reference_serve(cell))
    assert result["correct"]
    got = result["metrics"]
    for m in ("init_s", "warmup_s"):
        assert got[m]["value"] > 0 and got[m]["unit"] == "s"
