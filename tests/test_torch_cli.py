"""The port's qzip, qzstd and 7z command lines against the reference's.

Most cases call each package's ``main(argv)`` in this process on copies of
one input, the port's engine on ``torch.device("cpu")`` with the device
route forced in both packages (the kernels' plain versions), and hold the
files they write equal; gzip, zlib and an independent 7z parser are the
oracles.  Three cases run ``python -m qatzip_tpu_torch.cli.qzip`` in a
child process (a file, ``-d``, a pipe) and check that the child imported
no jax and no module of the reference package.
"""
import contextlib
import gzip
import io
import os
import shutil
import subprocess
import sys
import threading
import zlib

import pytest
import torch

from qatzip_tpu.cli import qzip as ref_qzip
from qatzip_tpu.cli import qzstd as ref_qzstd
from qatzip_tpu.cli import sevenz as ref_7z
from qatzip_tpu_torch.cli import qzip as port_qzip
from qatzip_tpu_torch.cli import qzstd as port_qzstd
from qatzip_tpu_torch.cli import sevenz as port_7z
from tests.test_7z import _spec_verify_7z
from tests.test_torch_api_ext import device_only, port  # noqa: F401

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK = ["-C", str(16 << 10)]
MAINS = {"ref": ref_qzip.main, "port": port_qzip.main}


def members(data: bytes, wbits: int) -> bytes:
    """Every catenated raw-deflate or zlib member, inflated."""
    out = bytearray()
    while data:
        d = zlib.decompressobj(wbits)
        out += d.decompress(data)
        assert d.eof
        data = d.unused_data
    return bytes(out)


def run(main, argv) -> int:
    try:
        main(argv)
    except SystemExit as exc:
        return exc.code
    return 0


def twin_dirs(tmp_path, files: dict) -> dict:
    """A directory a package, each with the same files and mtimes."""
    dirs = {}
    for name in MAINS:
        d = tmp_path / name
        for rel, data in files.items():
            p = d / rel
            p.parent.mkdir(parents=True, exist_ok=True)
            p.write_bytes(data)
            os.utime(p, (1_600_000_000, 1_600_000_000))
        dirs[name] = d
    return dirs


def run_both(dirs, argv_of) -> None:
    for name, main in MAINS.items():
        assert run(main, argv_of(dirs[name])) == 0, name


@pytest.mark.parametrize("fmt,suffix,decode", [
    ("gzip", ".gz", gzip.decompress),
    ("gzipext", ".gz", gzip.decompress),
    ("deflate_raw", ".deflate", lambda b: members(b, -15)),
    ("zlib", ".zz", lambda b: members(b, 15)),
    ("deflate_4B", ".4b", None),
])
def test_compress_file_equals_reference(corpus_factory, port, tmp_path,
                                        capsys, fmt, suffix, decode):
    data = corpus_factory(100_000)
    dirs = twin_dirs(tmp_path, {"file.bin": data})
    with device_only(port):
        run_both(dirs, lambda d: ["-k", "-O", fmt, *CHUNK,
                                  str(d / "file.bin")])
    out = {n: (d / ("file.bin" + suffix)).read_bytes()
           for n, d in dirs.items()}
    assert out["port"] == out["ref"]
    if decode is not None:
        assert decode(out["port"]) == data
    assert (dirs["port"] / "file.bin").exists()
    err = capsys.readouterr().err
    assert "Throughput" in err and "ratio" in err


def test_round_trip_deletes_sources_as_reference(corpus_factory, port,
                                                 tmp_path):
    """Without -k the source goes; -d restores it on the device and removes
    the .gz."""
    data = corpus_factory(60_000)
    dirs = twin_dirs(tmp_path, {"file.bin": data})
    run_both(dirs, lambda d: [*CHUNK, str(d / "file.bin")])
    for d in dirs.values():
        assert not (d / "file.bin").exists()
    assert (dirs["port"] / "file.bin.gz").read_bytes() == \
        (dirs["ref"] / "file.bin.gz").read_bytes()
    with device_only(port):
        assert run(port_qzip.main, ["-d", *CHUNK,
                                    str(dirs["port"] / "file.bin.gz")]) == 0
    assert (dirs["port"] / "file.bin").read_bytes() == data
    assert not (dirs["port"] / "file.bin.gz").exists()


def test_lz4_round_trip_equals_reference(corpus_factory, port, tmp_path):
    data = corpus_factory(60_000)
    dirs = twin_dirs(tmp_path, {"file.bin": data})
    with device_only(port):
        run_both(dirs, lambda d: ["-k", "-A", "lz4", *CHUNK,
                                  str(d / "file.bin")])
    lz4 = dirs["port"] / "file.bin.lz4"
    assert lz4.read_bytes() == (dirs["ref"] / "file.bin.lz4").read_bytes()
    out = dirs["port"] / "out.bin"
    with device_only(port):
        assert run(port_qzip.main, ["-d", "-o", str(out), *CHUNK,
                                    str(lz4)]) == 0
    assert out.read_bytes() == data


def _stdio(monkeypatch, main, argv, data: bytes) -> bytes:
    stdout = io.TextIOWrapper(io.BytesIO())
    monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(io.BytesIO(data)))
    monkeypatch.setattr(sys, "stdout", stdout)
    assert run(main, argv) == 0
    return stdout.buffer.getvalue()


def test_stdin_stdout_stream_equals_reference(corpus_factory, port,
                                              monkeypatch):
    """No files: stdin through the stream API to stdout, both ways."""
    data = corpus_factory(80_000)
    with device_only(port):
        comp = {n: _stdio(monkeypatch, m, CHUNK, data)
                for n, m in MAINS.items()}
    assert comp["port"] == comp["ref"]
    assert gzip.decompress(comp["port"]) == data
    assert _stdio(monkeypatch, port_qzip.main, ["-d", *CHUNK],
                  comp["port"]) == data


def test_recursive_dir_and_knobs_equal_reference(corpus_factory, port,
                                                 tmp_path):
    """-R over a tree; -r/-P/-S/-g with -o (the suffix is appended; -S, the
    latency-sensitive router, may pick the CPU, as in the reference)."""
    files = {"tree/a.txt": corpus_factory(5000),
             "tree/sub/b.txt": corpus_factory(7000),
             "x.txt": b"knobs " * 2000}
    dirs = twin_dirs(tmp_path, files)
    with device_only(port):
        run_both(dirs, lambda d: ["-k", "-R", *CHUNK, str(d / "tree")])
    run_both(dirs, lambda d: ["-k", "-r", "3", "-P", "busy", "-S", "-g", "1",
                              "-o", str(d / "x"), str(d / "x.txt")])
    for rel in ("tree/a.txt.gz", "tree/sub/b.txt.gz", "x.gz"):
        got = (dirs["port"] / rel).read_bytes()
        assert got == (dirs["ref"] / rel).read_bytes()
        assert gzip.decompress(got) == files[rel.rsplit(".", 1)[0]
                                             if rel != "x.gz" else "x.txt"]


@pytest.mark.parametrize("argv,message", [
    (["-Z"], "unrecognized arguments"),
    ([], "is a directory"),
    (["missing.bin"], "no such file"),
])
def test_errors_exit_as_reference(port, tmp_path, capsys, argv, message):
    d = tmp_path / "d"
    d.mkdir()
    argv = argv or [str(d)]
    got = {}
    for name, main in MAINS.items():
        got[name] = (run(main, argv), capsys.readouterr().err)
    assert got["port"] == got["ref"]
    assert got["port"][0] != 0
    if message:
        assert message in got["port"][1]


def test_fifo_input_streams_into_an_explicit_output(corpus_factory, port,
                                                    tmp_path, capsys):
    """A FIFO stands in for a device node: it streams through the stream
    API into -o; without -o it is refused before it is opened."""
    data = corpus_factory(100_000)
    out = {}
    for name, main in MAINS.items():
        fifo = tmp_path / f"{name}_fifo"
        os.mkfifo(fifo)

        def feeder():
            with open(fifo, "wb") as f:
                f.write(data)

        t = threading.Thread(target=feeder)
        t.start()
        target = tmp_path / f"{name}.gz"
        with (device_only(port) if name == "port"
              else contextlib.nullcontext()):
            assert run(main, ["-k", *CHUNK, str(fifo), "-o",
                              str(target)]) == 0
        t.join(timeout=60)
        assert not t.is_alive()
        out[name] = target.read_bytes()
    assert out["port"] == out["ref"]
    assert gzip.decompress(out["port"]) == data
    os.mkfifo(tmp_path / "f2")
    capsys.readouterr()
    assert run(port_qzip.main, [str(tmp_path / "f2")]) == 1
    assert "requires -o" in capsys.readouterr().err


def test_zstd_pipeline_and_qzstd_equal_reference(corpus_factory, port,
                                                 tmp_path):
    """qzip -A zstd and qzstd: LZ4s on the device, the zstd callback after
    it; standard Zstd frames equal to the reference's, read back by qzstd
    -d."""
    zstandard = pytest.importorskip("zstandard")
    data = corpus_factory(60_000)
    dirs = twin_dirs(tmp_path, {"file.bin": data, "z.bin": data})
    with device_only(port):
        run_both(dirs, lambda d: ["-k", "-A", "zstd", *CHUNK, "-o",
                                  str(d / "file"), str(d / "file.bin")])
        for name, main in (("ref", ref_qzstd.main),
                           ("port", port_qzstd.main)):
            assert run(main, ["-k", *CHUNK, str(dirs[name] / "z.bin")]) == 0
    for rel in ("file.zst", "z.bin.zst"):
        got = (dirs["port"] / rel).read_bytes()
        assert got == (dirs["ref"] / rel).read_bytes()
        reader = zstandard.ZstdDecompressor().stream_reader(
            io.BytesIO(got), read_across_frames=True)
        assert reader.read() == data
    back = dirs["port"] / "back.bin"
    assert run(port_qzstd.main, ["-d", "-k", "-o", str(back),
                                 str(dirs["port"] / "z.bin.zst")]) == 0
    assert back.read_bytes() == data


# ---------------------------------------------------------------------------
# 7z
# ---------------------------------------------------------------------------
def test_7z_number_codec_equals_reference():
    for v in [0, 1, 0x7F, 0x80, 0x3FFF, 0x4000, 123456, 2**20, 2**31,
              2**40 + 17, 2**56 - 1, 2**63, 2**64 - 1]:
        enc = port_7z._write_number(v)
        assert enc == ref_7z._write_number(v)
        assert port_7z._read_number(memoryview(enc), 0) == (v, len(enc))


def _tree(corpus_factory) -> dict:
    return {"src/a.txt": corpus_factory(50_000),
            "src/sub/b.bin": corpus_factory(30_000, "iterative"),
            "src/empty.txt": b""}


def test_7z_archive_equals_reference_and_extracts(corpus_factory, tmp_path):
    files = _tree(corpus_factory)
    dirs = twin_dirs(tmp_path, files)
    arcs = {}
    for name, mod in (("ref", ref_7z), ("port", port_7z)):
        src = dirs[name] / "src"
        os.utime(src / "sub", (1_600_000_000, 1_600_000_000))
        os.utime(src, (1_600_000_000, 1_600_000_000))
        arc = tmp_path / f"{name}.7z"
        total, size = mod.write_7z(str(arc), [str(src)])
        assert size == arc.stat().st_size
        arcs[name] = arc.read_bytes()
    assert arcs["port"] == arcs["ref"]
    _spec_verify_7z(str(tmp_path / "port.7z"),
                    {k: v for k, v in files.items() if v})
    raw = arcs["port"]
    assert raw[:6] == b"7z\xbc\xaf\x27\x1c"
    dest = tmp_path / "x"
    dest.mkdir()
    port_7z.SevenZReader(str(tmp_path / "port.7z")).extract_all(str(dest))
    for rel, data in files.items():
        assert (dest / rel).read_bytes() == data
    assert (dest / "src" / "sub").is_dir()
    bad = bytearray(raw)
    bad[40] ^= 0xFF
    (tmp_path / "bad.7z").write_bytes(bytes(bad))
    with pytest.raises((ValueError, zlib.error)):
        port_7z.SevenZReader(str(tmp_path / "bad.7z")).extract_all(str(dest))


def test_7z_cli_one_archive_for_all_inputs(tmp_path, port):
    """-O 7z catenates every input of one run into one archive, which -d
    extracts; the archive equals the reference's."""
    files = {"a.txt": b"alpha " * 100, "b.bin": bytes(range(256)) * 10,
             "sub/c.txt": b"nested file", "sub/deep/empty.txt": b""}
    dirs = twin_dirs(tmp_path, files)
    for d in dirs.values():
        for sub in ("sub/deep", "sub"):
            os.utime(d / sub, (1_600_000_000, 1_600_000_000))
    run_both(dirs, lambda d: ["-k", "-O", "7z", "-o", str(d / "all.7z"),
                              str(d / "a.txt"), str(d / "b.bin"),
                              str(d / "sub")])
    arc = dirs["port"] / "all.7z"
    assert arc.read_bytes() == (dirs["ref"] / "all.7z").read_bytes()
    assert not (dirs["port"] / "a.txt.7z").exists()
    dest = tmp_path / "out"
    dest.mkdir()
    assert run(port_qzip.main, ["-d", "-k", "-o", str(dest), str(arc)]) == 0
    assert (dest / "a.txt").read_bytes() == files["a.txt"]
    assert (dest / "b.bin").read_bytes() == files["b.bin"]
    assert (dest / "sub" / "c.txt").read_bytes() == b"nested file"
    assert (dest / "sub" / "deep" / "empty.txt").read_bytes() == b""


# ---------------------------------------------------------------------------
# python -m qatzip_tpu_torch.cli.qzip in a child process
# ---------------------------------------------------------------------------
def run_child(args, stdin: bytes = b""):
    """The CLI in a child that prints its imports (-X importtime); returns
    (process, imported module names)."""
    env = dict(os.environ, PYTHONPATH=REPO, QATZIP_TPU_DEVICE="1")
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "qatzip_tpu_torch.cli.qzip",
         *args], input=stdin, capture_output=True, env=env, timeout=300)
    mods = [ln.rsplit("|", 1)[-1].strip() for ln in
            proc.stderr.decode(errors="replace").splitlines()
            if ln.startswith("import time:")]
    assert "qatzip_tpu_torch.api" in mods
    bad = [m for m in mods if m.split(".")[0] in ("jax", "qatzip_tpu")]
    assert not bad, bad
    return proc


def test_child_file_compress_and_decompress(corpus_factory, tmp_path):
    data = corpus_factory(80_000)
    f = tmp_path / "file.bin"
    f.write_bytes(data)
    proc = run_child(["-k", "-O", "gzip", str(f)])
    assert proc.returncode == 0, proc.stderr[-2000:]
    gz = tmp_path / "file.bin.gz"
    assert gzip.decompress(gz.read_bytes()) == data
    shutil.move(gz, tmp_path / "copy.gz")
    proc = run_child(["-d", str(tmp_path / "copy.gz")])
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert (tmp_path / "copy").read_bytes() == data
    assert not (tmp_path / "copy.gz").exists()


def test_child_pipe(corpus_factory):
    data = corpus_factory(80_000)
    proc = run_child([], stdin=data)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert gzip.decompress(proc.stdout) == data
