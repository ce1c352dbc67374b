"""Check and time the construct probes' Hopper kernels on a CUDA card.

    python3 -m qatzip_tpu_torch.tools.probe_bench [--against DIR ...]

Builds ``libqzprobes.so`` (qatzip_tpu_torch/tools/probes.cu), then runs
every case of ``CASES``: the probes at the TPU probes' own shapes, and the
chain, step, token and refill probes also at the inflate path's (512
lanes, one round of a 32 MB request; 8 KB of tables a lane).  A case first
holds its kernel against the plain version on the same inputs at a small
trip count K (equal, or AssertionError), then times the kernel there two
ways, beside one PyTorch call that computes the same where there is one,
timed the same two ways: host-paced (``ms``: 5 calls launched through
Python in turn, CUDA events around them) and graph-replayed (``graph_ms``:
one replay of a CUDA graph of 20 calls, the device's time alone).  Then it
times the kernel at two trip counts and prints the slope, ns a unit =
(t(K_hi) - t(K_lo)) / (K_hi - K_lo) (the TPU probes' own method,
tools/probe_inflate_step5.py:53), beside the clock64() ticks a unit of one
thread.  First come the launch floor (an empty kernel, both ways), which
every record carries, and the host pieces of a launch (the bare ctypes
call, the stream read, an allocation, whole wrappers), microseconds a call
by time.perf_counter.  The inputs come from a torch.Generator seeded per
case.  ``--against`` builds each named checkout's probes.cu (an earlier
commit unpacked with ``git archive`` under ``build/``) and times its ROLL,
REFILL, TRANSPOSE, DEP (p_gather and the two slopes chip_smoke reads),
COLUMN, STEP3, STEP5, TOKENS, INDEP, BITONIC and 64K row sort wrappers
and kernels beside this checkout's in turns (old, new, new, old; the row
sort beside an older checkout's sort_u32 route, through this checkout's
sort_u32); INDEP also over lanes that stay in order (no bank conflict)
beside random ones.
chip_smoke.py runs the same cases (``run``) and puts their records in its
kernels line.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import re
import subprocess
import time
from dataclasses import dataclass, field
from typing import Callable

import torch

from qatzip_tpu_torch.ops import _build
from qatzip_tpu_torch.ops import sort as SO
from qatzip_tpu_torch.tools import probes as P
from qatzip_tpu_torch.tools.h100 import FP32_OPS_S, HBM_BYTES_S
from qatzip_tpu_torch.tools.parity_bench import graph_ms

SRC = "qatzip_tpu_torch/tools/probes.cu"
INFLATE_LANES = 512     # DeflateDeviceCodec.LOCKSTEP_BATCH: a round's lanes
INFLATE_WORDS = 2048    # QZ_SMEM_WORDS: a lane's widened tables, 8 KB


@dataclass
class Case:
    """One probe at one shape.  ``make(gen)`` gives CPU inputs; ``run(x,
    K, clk)`` calls the wrapper (the kernel for CUDA inputs); ``plain(x,
    K)`` the plain version; ``units`` what one K is; ``work(x, K)`` the
    (bytes, integer operations) the function needs; ``library(x)`` one
    PyTorch call computing the same at K = k (or None).  ``host``: the
    inputs the wrapper takes on the CPU (a refill's offsets); plain and
    library take every input on the card.  ``args``: a ROLL, REFILL or
    DEP wrapper's own arguments, for :func:`against`.  ``cluster``: the
    CTAs of a cluster kernel, each of which writes the SM it ran on into
    ``clk[1 + rank]``.  ``dep_loads``: the dependent shared-memory loads
    of one unit, whose latency bounds it (0: not latency-bound).
    ``ctas``: the CTAs of its launch, where an empty kernel of as many
    CTAs is timed beside it (0: none).  A
    case's ``args["call"](mod, x, K, clk)``, where given, calls the
    wrapper of another checkout's probes module mod (:func:`against`)."""
    name: str
    kernel: str
    replaces: str
    shape: str
    units: str
    make: Callable
    run: Callable
    plain: Callable
    k: int
    k_lo: int | None
    k_hi: int | None
    work: Callable
    library: Callable | None = None
    source: str = SRC
    host: tuple = ()
    args: dict = field(default_factory=dict)
    cluster: int = 0
    dep_loads: int = 0
    ctas: int = 0


def _u32(gen, shape) -> torch.Tensor:
    return P._i32(torch.randint(0, 1 << 32, shape, generator=gen,
                                dtype=torch.int64))


def _ints(gen, lo, hi, shape) -> torch.Tensor:
    return torch.randint(lo, hi, shape, generator=gen,
                         dtype=torch.int64).to(torch.int32)


def _nbytes(*ts) -> int:
    return sum(t.numel() * 4 for t in ts if isinstance(t, torch.Tensor))


def _elementwise(ops_per_step: int):
    """work of K steps over every element of the last input: the inputs
    read once, an output like the last input written once."""
    def work(x, K):
        return _nbytes(*x) + _nbytes(x[-1]), K * x[-1].numel() * ops_per_step
    return work


def _chain_case(name, mode, replaces, shape, t_shape, i_shape, k, k_lo, k_hi,
                *, smem=True, ops=2, units="dependent load a lane",
                library=None, dep_loads=0, make=None):
    """Tables of values in [0, 2^20), indexes in range of the table (or
    make's inputs).  An INDEP case calls another checkout's wrapper in
    --against, and times an empty kernel of its grid beside it."""
    def tables(gen):
        return (_ints(gen, 0, 1 << 20, t_shape),
                _ints(gen, 0, t_shape[-1], i_shape))

    def call(mod, x, K, clk=None):
        return mod.probe_chain(mode, x[0], x[1], K, smem=smem, clk=clk)

    indep = mode != "dep"
    threads = min(128, -(-i_shape[-1] // 32) * 32)
    return Case(name, "qz_probe_indep" if indep else "qz_probe_dep",
                replaces, shape, units, make or tables,
                lambda x, K, clk=None: call(P, x, K, clk),
                lambda x, K: _PLAIN_CHAIN[mode](x, K), k, k_lo, k_hi,
                _elementwise(ops), library,
                args={"call": call, "smem": smem} if indep else
                {"smem": smem}, dep_loads=dep_loads,
                ctas=(-(-i_shape[-1] // threads) * i_shape[0]) if indep
                else 0)


def _lanes_in_order(gen):
    """INDEP's inputs with every warp's lanes on consecutive words at every
    step (a table of ones, idx[r, j] = j), so that no load of a row staged
    once queues on a bank: against random indexes, what bank conflicts
    cost."""
    return (torch.ones((128, 128), dtype=torch.int32),
            torch.arange(128, dtype=torch.int32).repeat(128, 1))


_PLAIN_CHAIN = {
    "dep": lambda x, K: P.dep_gather_loop(x[0], x[1], K),
    "indep4": lambda x, K: P.indep_gather_loop(x[0], x[1], K, 4),
    "indep8": lambda x, K: P.indep_gather_loop(x[0], x[1], K, 8),
}


def _column_case(name, shape, n, rows, hi, *, post=None, smem=True):
    """COLUMN over [n, 128] columns of values in [0, hi) and [rows, 128]
    indexes in [0, n), K 8.  Another checkout without probe_column runs
    it through probe_chain."""
    def make(gen):
        return _ints(gen, 0, hi, (n, 128)), _ints(gen, 0, n, (rows, 128))

    def call(mod, x, K, clk=None):
        fn = getattr(mod, "probe_column", None)
        if fn is None:
            return mod.probe_chain("column", x[0], x[1], K, smem=smem,
                                   post=post, clk=clk)
        return fn(x[0], x[1], K, smem=smem, post=post, clk=clk)

    return Case(name, "qz_probe_column", _COLUMN, shape,
                "dependent column load a lane", make,
                lambda x, K, clk=None: call(P, x, K, clk),
                lambda x, K: P._column(x[0], x[1], K,
                                       n - 1 if post is None else post),
                8, 1024, 4096, _elementwise(4),
                args={"call": call, "smem": smem}, dep_loads=1)


def _walk_case():
    def make(gen):
        return (_u32(gen, (8, 128)),)

    def call(mod, x, K, clk=None):
        return mod.probe_chain("walk", x[0], None, K, clk=clk)

    return Case("probe_chain_walk", "qz_probe_chain",
                "tools/probe_pallas.py:107",
                "[8, 128], one thread", "serial step", make,
                lambda x, K, clk=None: call(P, x, K, clk),
                lambda x, K: P.scalar_walk(x[0], K), 512, 4096, 16384,
                lambda x, K: (_nbytes(x[0]) + 4, K * 5),
                args={"call": call}, dep_loads=1)


def _alu_case(name, mode, replaces, plain, shape, k, library=None):
    def make(gen):
        return (_u32(gen, shape),)

    def call(mod, x, K, clk=None):
        return mod.probe_alu(mode, x[0], K, clk)

    return Case(name, "qz_probe_alu", replaces, str(list(shape)),
                "step a lane", make, lambda x, K, clk=None: call(P, x, K, clk),
                lambda x, K: plain(x[0], K), k, 16384, 131072,
                _elementwise({"hash": 6, "ew": 3, "double": 1, "shfl": 1,
                              "bar": 1}[mode]), library,
                args={"call": call})


def _step3_case(lpc):
    def make(gen):
        return tuple(_u32(gen, (128, 128)) for _ in range(3)) + (
            _ints(gen, 0, 1 << 12, (128, 128)),)

    def call(mod, x, K, clk=None):
        return mod.probe_step("step3", "none", *x, K, lanes_per_cta=lpc,
                              clk=clk)[0]

    # five levels of dependent loads a step: the two window words, the
    # litlen root, its subtable, the distance root, its subtable
    return Case(f"probe_step_step3_lpc{lpc}", "qz_probe_step",
                "tools/probe_inflate_step3.py:81",
                f"[128, 128], {lpc} lanes a CTA",
                "step a lane", make,
                lambda x, K, clk=None: call(P, x, K, clk),
                lambda x, K: P.step_loop(*x, K), 4, 1024, 4096,
                _elementwise(30), args={"call": call}, dep_loads=5,
                ctas=128 * 128 // lpc)


def _step5_case(lanes, rc, lpc, store="none"):
    W, sc = 128, 256

    def make(gen):
        return (_u32(gen, (W, lanes)), _u32(gen, (rc + sc, lanes)),
                _u32(gen, (rc + sc, lanes)), _ints(gen, 0, 1000, (1, lanes)))

    def call(mod, x, K, clk=None):
        out, toks = mod.probe_step("step5", store, *x, K, lanes_per_cta=lpc,
                                   root_cells=rc, sub_cells=sc, clk=clk)
        return (out, toks) if store != "none" else out

    def plain(x, K):
        bp, toks = P.lane_major_step(*x, K, rc, sc)
        return (bp, toks) if store != "none" else bp

    def work(x, K):
        return (_nbytes(*x) + _nbytes(x[-1])
                + (K * lanes * 4 if store != "none" else 0), K * lanes * 70)

    where = "the inflate round" if lanes == INFLATE_LANES else "TPU probe"
    return Case(f"probe_step_step5_{lanes}l_root{rc}_lpc{lpc}"
                + ("" if store == "none" else f"_{store}"), "qz_probe_step",
                "tools/probe_inflate_step5.py:249",
                f"{lanes} lanes ({where}), W {W}, root {rc} + sub {sc} cells, "
                f"{lpc} lanes a CTA, tokens {store}", "step a lane", make,
                lambda x, K, clk=None: call(P, x, K, clk), plain, 4, 512,
                2048, work, args={"call": call}, dep_loads=5)


def _tokens_case(lanes, lpc, store):
    tile = 256

    def make(gen):
        return (_ints(gen, 0, 3, (lanes // 128, 128)),
                _ints(gen, 0, 128, (lanes // 128, 128)))

    def call(mod, x, K, clk=None):
        return mod.probe_step("tokens", store, None, x[0], None, x[1], K,
                              lanes_per_cta=lpc, tile=tile, clk=clk)[1]

    return Case(f"probe_step_tokens_{lanes}l_lpc{lpc}_{store}",
                "qz_probe_step", "tools/probe_inflate_step4.py:92",
                f"{lanes} lanes, {lpc} lanes a CTA, tile {tile}, store "
                f"{store}",
                "step a lane (a token stored)", make,
                lambda x, K, clk=None: call(P, x, K, clk),
                lambda x, K: P.tokens_dma(x[0], x[1], K)[0], tile, 1024,
                4096, lambda x, K: (_nbytes(*x) + K * lanes * 4,
                                    K * lanes * 3), args={"call": call},
                dep_loads=1)


def _roll_case(S, shift, axis, replaces):
    def make(gen):
        return (_ints(gen, 0, 1 << 30, (S, 128)),)

    return Case(f"probe_tile_roll_{S}x128_axis{axis}", "qz_probe_roll",
                replaces, f"[{S}, 128], shift {shift}, axis {axis}",
                "call", make,
                lambda x, K, clk=None: P.probe_roll(x[0], shift, axis),
                lambda x, K: P.roll(x[0], shift, axis), 1, None, None,
                lambda x, K: (2 * _nbytes(x[0]), 0),
                lambda x: torch.roll(x[0], shift, axis),
                args={"shift": shift, "axis": axis})


def _transpose_case():
    """The TPU probe's [128, 128] tile."""
    def make(gen):
        return (_u32(gen, (128, 128)),)

    return Case("probe_tile_transpose", "qz_probe_transpose",
                "tools/probe_inflate_step5.py:63 (mk_transpose)",
                "[128, 128], a cluster of 16 CTAs, st.async on the partner's "
                "mbarrier", "transpose + 1", make,
                lambda x, K, clk=None: P.probe_transpose(x[0], K, clk),
                lambda x, K: P.transpose(x[0], K), 1, 64, 512,
                lambda x, K: (2 * _nbytes(x[0]), K * x[0].numel()),
                lambda x: x[0].t() + 1,
                cluster=P.transpose_plan(128)["ctas"])


def _refill_case(name, replaces, B, NW, win, how, alt=0, blocks=False,
                 k=1, k_lo=256, k_hi=2048):
    def make(gen):
        stream = _u32(gen, (B, NW))
        if blocks:   # a block index a lane, blocks of alt words
            off = _ints(gen, 0, NW // alt - 2, (B,)) * alt
        else:
            off = _ints(gen, 0, NW - win - alt, (B,))
        return stream, off

    def work(x, K):
        """the offsets and the windows read (two when odd refills move by
        alt), the last windows written"""
        reads = 2 if alt and K > 1 else 1
        return B * 4 + (reads + 1) * B * win * 4, 0

    def library(x):   # the last window of each lane, one gather
        o = x[1].to(torch.int64).reshape(-1, 1) + ((k - 1) & 1) * alt
        return torch.gather(x[0], 1, o + torch.arange(win, device=o.device))

    return Case(f"probe_tile_{name}_{B}l_{how}", "qz_probe_refill", replaces,
                f"{B} lanes, stream {NW} words, window {win}"
                + (f", blocks of {alt}" if blocks else ""),
                "refill a lane", make,
                lambda x, K, clk=None: P.probe_refill(x[0], x[1], win, K,
                                                      alt=alt, how=how,
                                                      clk=clk),
                lambda x, K: P._refill(x[0], x[1], win, K, alt), k, k_lo,
                k_hi, work, library, host=(1,),
                args={"win": win, "alt": alt, "how": how})


def _bitonic_case(segment, replaces):
    def make(gen):
        return (_u32(gen, (8, 128)),)

    n = {"flat": 1024, "rows": 128, "cols": 8}[segment]
    lg = n.bit_length() - 1

    def library(x):
        if segment == "flat":
            return torch.sort(x[0].reshape(-1)).values
        return torch.sort(x[0], dim=1 if segment == "rows" else 0).values

    def call(mod, x, K, clk=None):
        return mod.probe_bitonic(x[0], segment, K, clk)

    return Case(f"probe_tile_bitonic_{segment}", "qz_probe_tile", replaces,
                f"[8, 128], segments of {n}", "sort of the tile", make,
                lambda x, K, clk=None: call(P, x, K, clk),
                lambda x, K: P.bitonic(x[0], segment), 1, 16, 64,
                lambda x, K: (2 * _nbytes(x[0]),
                              K * 3 * 512 * lg * (lg + 1) // 2),
                library, args={"call": call, "seg_n": n})


def _sort_case(B, signed=False):
    """A 64K sort of B rows (qz_probe_bitonic_row): the TPU probe's keys
    (< 2^30), or (signed) full-range keys with negatives and repeats.  A
    checkout whose probes.py has no row sort is called through the route
    it took, sort_u32 (csrc/sort.cu, this checkout's: the row sort left it
    as it was) once a sort, K times; it writes no clock ticks and sorts in
    uint32 order, so --against leaves out the signed case."""
    def make(gen):
        if not signed:
            return (_ints(gen, 0, 1 << 30, (B, 65536)),)
        x = _u32(gen, (B, 65536))
        x[:, 1::7] = x[:, ::7][:, :x[:, 1::7].shape[1]]
        x[:, 2::5] = _ints(gen, -3, 3, x[:, 2::5].shape)
        return (x,)

    def call(mod, x, K, clk=None):
        if hasattr(mod, "probe_bitonic_64k"):
            return mod.probe_bitonic_64k(x[0], K, clk=clk)
        y = x[0]
        for _ in range(K):
            y = SO.sort_u32(x[0])[0]
        return y

    lg = 16
    return Case(f"probe_sort_{B}x65536" + ("_signed" if signed else ""),
                "qz_probe_bitonic_row",
                "tools/probe_pallas.py:154" if B == 1 else
                "tools/probe_pallas.py:186,225",
                f"[{B}, 65536] "
                + ("int32 keys, negatives and repeats" if signed
                   else "keys < 2^30")
                + f", a cluster of {P.ROW_CTAS} CTAs a row",
                "sort of the rows", make,
                lambda x, K, clk=None: call(P, x, K, clk),
                lambda x, K: P.bitonic(x[0].view(B, 512, 128), "flat")
                .reshape(B, 65536), 1, 4, 16,
                lambda x, K: (2 * _nbytes(x[0]),
                              K * 3 * B * 65536 // 2 * lg * (lg + 1) // 2),
                lambda x: torch.sort(x[0], dim=1).values,
                args={"call": call, "seg_n": 65536}, cluster=P.ROW_CTAS)


_DEP = ("tools/probe_inflate_step.py:53, tools/probe_inflate_step3.py:44, "
        "tools/probe_pallas4.py:48,124")
_COLUMN = ("tools/probe_inflate_step5.py:63 (mk_subshuf, mk_onehot, "
           "mk_groupsel)")
_REFILL_D = "tools/probe_inflate_step.py:121"
# SHFL and BAR replace no TPU kernel: the units of BITONIC's stages across
# threads, in which its design's latency figure is counted
_NONE = "none (BITONIC's stages across threads)"


def _cases() -> list:
    IL, IW = INFLATE_LANES, INFLATE_WORDS
    cases = [
        _chain_case("probe_chain_dep", "dep", _DEP, "[128, 128] rows of 128",
                    (128, 128), (128, 128), 8, 4096, 16384),
        _chain_case("probe_chain_dep_ldg", "dep", _DEP,
                    "[128, 128] rows of 128, table through __ldg",
                    (128, 128), (128, 128), 8, 4096, 16384, smem=False),
        _chain_case("probe_chain_indep4", "indep4",
                    "tools/probe_inflate_step.py:74", "[128, 128], W 4",
                    (128, 128), (128, 128), 4, 2048, 8192, ops=13,
                    units="step of 4 independent loads a lane", dep_loads=1),
        _chain_case("probe_chain_indep8", "indep8",
                    "tools/probe_inflate_step.py:74", "[128, 128], W 8",
                    (128, 128), (128, 128), 4, 2048, 8192, ops=25,
                    units="step of 8 independent loads a lane", dep_loads=1),
        _chain_case("probe_chain_indep8_lanes_in_order", "indep8",
                    "tools/probe_inflate_step.py:74",
                    "[128, 128], W 8, a table of ones, idx[r, j] = j",
                    (128, 128), (128, 128), 4, 2048, 8192, ops=25,
                    units="step of 8 independent loads a lane", dep_loads=1,
                    make=_lanes_in_order),
        _chain_case("probe_chain_dep_grid32", "dep", _DEP,
                    "[32 x 512, 128] (p_chain_grid)", (16384, 128),
                    (16384, 128), 16, 16, 64),
        *(_chain_case(f"probe_chain_gather{w}", "dep",
                      "tools/probe_pallas.py:82",
                      f"[8, {w}] table, [8, {w}] idx (p_gather)", (8, w),
                      (8, w), 1, 1024, 4096,
                      library=lambda x: torch.gather(x[0], 1, x[1].long()))
          for w in (128, 1024)),
        _chain_case("probe_chain_tbl1024", "dep", "tools/probe_pallas4.py:79",
                    "[512, 128] indexes, one 1024-entry table", (1, 1024),
                    (512, 128), 1, 1024, 4096,
                    library=lambda x: torch.take(x[0], x[1].to(torch.int64))),
        _chain_case(f"probe_chain_dep_{IL}l_{IW}w", "dep", _DEP,
                    f"{IL} lanes a thread each, {IW}-word tables (8 KB)",
                    (IL, IW), (IL, 1), 8, 4096, 16384),
        _chain_case(f"probe_chain_dep_{IL}l_{IW}w_ldg", "dep", _DEP,
                    f"{IL} lanes a thread each, {IW}-word tables through "
                    "__ldg", (IL, IW), (IL, 1), 8, 4096, 16384, smem=False),
        _column_case("probe_chain_column_onehot128",
                     "[128, 128] columns, [1, 128] idx (C)", 128, 1, 128),
        _column_case("probe_chain_column_groupsel512",
                     "[512, 128] columns, [8, 128] idx (C2)", 512, 8, 512),
        _column_case("probe_chain_column_subshuf",
                     "[8, 128] columns, [8, 128] idx (B)", 8, 8, 8,
                     post=0xFFFFFFFF),
        _column_case("probe_chain_column_onehot128_ldg",
                     "[128, 128] columns through __ldg, [1, 128] idx (C)",
                     128, 1, 128, smem=False),
        _walk_case(),
        _alu_case("probe_alu_hash", "hash", "tools/probe_inflate_step.py:92",
                  P.elemwise_loop, (128, 128), 8),
        _alu_case("probe_alu_ew", "ew",
                  "tools/probe_inflate_step5.py:63 (mk_ew)",
                  P.ew, (128, 128), 8),
        _alu_case("probe_alu_double", "double", "tools/probe_pallas.py:53",
                  P.double, (8, 128), 1, library=lambda x: x[0] * 2),
        _alu_case("probe_alu_shfl", "shfl", _NONE, P.shfl_pairs, (128, 128),
                  8),
        _alu_case("probe_alu_bar", "bar", _NONE, P.count_up, (128, 128), 8),
        _step3_case(32),
        _step3_case(1),
        _step5_case(128, 256, 1),
        _step5_case(128, 128, 1),
        _step5_case(128, 256, 8),
        _step5_case(128, 256, 32),
        _step5_case(IL, 256, 1),
        _step5_case(IL, 256, 8),
        _step5_case(IL, 256, 32),
        _step5_case(IL, 256, 1, "lone"),
        _tokens_case(128, 1, "lone"),
        _tokens_case(128, 32, "lone"),
        _tokens_case(128, 32, "tile"),
        _tokens_case(IL, 1, "lone"),
        _tokens_case(IL, 32, "lone"),
        _tokens_case(IL, 32, "tile"),
        _roll_case(512, 64, 0, "tools/probe_pallas3.py:26"),
        _roll_case(8, 1, 1, "tools/probe_pallas.py:68, "
                   "tools/probe_pallas3.py:26"),
        _transpose_case(),
    ]
    for how in ("ld", "cp", "tma"):
        cases.append(_refill_case("refill_dma", _REFILL_D, 128, 4096, 128,
                                  how))
        cases.append(_refill_case("refill_dma", _REFILL_D, IL, 4096, 128,
                                  how))
    cases += [
        _refill_case("refill_vmem", "tools/probe_inflate_step3.py:104", 128,
                     4096, 64, "ld"),
        _refill_case("refill3d", "tools/probe_inflate_step4.py:53", 128,
                     256 * 64, 128, "ld", alt=64, blocks=True, k=2, k_lo=256,
                     k_hi=2048),
        _refill_case("refill3d", "tools/probe_inflate_step4.py:53", 128,
                     256 * 64, 128, "tma", alt=64, blocks=True, k=2,
                     k_lo=256, k_hi=2048),
        _bitonic_case("flat", "tools/probe_pallas3.py:77"),
        _bitonic_case("rows", "tools/probe_pallas3.py:113"),
        _bitonic_case("cols", "tools/probe_pallas3.py:145"),
        _sort_case(1),
        _sort_case(32),
        _sort_case(32, signed=True),
    ]
    return cases


CASES = _cases()
GRAPH_REPS = 20     # calls a graph holds in graph_ms
FLOOR_REPS = 100    # host-paced calls of the empty kernel a floor
CLK_WORDS = 64      # a slope's clk: the ticks, then a cluster's SMs
# the cases whose wrappers run sync-free and from a graph, and that
# --against times: these kernels' and, by case name, STEP3's, STEP5's and
# TOKENS'
REDESIGNED = ("qz_probe_roll", "qz_probe_refill", "qz_probe_transpose",
              "qz_probe_dep", "qz_probe_column", "qz_probe_indep",
              "qz_probe_tile", "qz_probe_bitonic_row")
STEP_REDESIGNED = ("probe_step_step3_", "probe_step_step5_",
                   "probe_step_tokens_")
# a dependent integer instruction on an H100, in clocks: the STEP5
# skeleton's carried SASS chain (27 instructions, 5 of them loads) against
# its clocks a step (PERF.md §6)
INT_CLOCKS = 4.5
# the dependent shared-memory load that latency bounds are counted in
DEP_LOAD = f"probe_chain_dep_{INFLATE_LANES}l_{INFLATE_WORDS}w"
AGAINST_DEP = ("probe_chain_gather128", "probe_chain_gather1024",
               "probe_chain_dep", f"probe_chain_dep_{INFLATE_LANES}l_"
               f"{INFLATE_WORDS}w")
# the probes left as they were, whose slopes --against holds beside the
# redesigned ones'
AGAINST_OTHER = ("probe_chain_walk", "probe_alu_hash", "probe_alu_ew",
                 "probe_alu_double")
# the cases an older checkout's route does not compute (sort_u32's uint32
# order)
AGAINST_NOT = ("probe_sort_32x65536_signed",)


def redesigned(case: Case) -> bool:
    """A case of a redesigned probe (graph-safe, timed by --against)."""
    return (case.kernel in REDESIGNED
            or case.name.startswith(STEP_REDESIGNED))


def _time_ms(fn, reps: int) -> float:
    """Mean ms a call of fn on the current stream, after one warm call:
    host-paced, each call launched through Python in turn."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def launch_floor(dev) -> dict:
    """The empty kernel's ms a launch, host-paced and graph-replayed."""
    return {"ms": _time_ms(lambda: P.launch_floor(dev), FLOOR_REPS),
            "graph_ms": graph_ms(lambda: P.launch_floor(dev), GRAPH_REPS)}


def _bare(symbol: str, argtypes: list):
    """The probes library's C entry symbol as a bare ctypes function."""
    fn = getattr(_build.library(_build.PROBES), symbol)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def host_pieces(dev, n: int = 5000, others: dict | None = None) -> dict:
    """Microseconds a call of each host piece of a probe's launch, by
    time.perf_counter over n calls after a warm one (launches drained by a
    synchronize inside the span): the bare ctypes call (the empty entry
    told not to launch), that call launching the empty kernel, the launch
    floor's wrapper, the stream read (torch's Stream object and the raw
    handle), an allocation (two ways), DEP's wrapper pieces (the device
    and type checks, two contiguous reshapes, a 13- and an 11-argument
    ctypes call that the entry refuses at once), and the ROLL, REFILL,
    TRANSPOSE and DEP wrappers beside their PyTorch calls on their TPU
    probes' shapes; others: {label: another checkout's probes module},
    whose TRANSPOSE and DEP wrappers are timed too.  dev: a CUDA device
    with its index."""
    fn = _bare("qz_probe_empty", P.EMPTY.argtypes)
    chain = _bare("qz_probe_chain", P.CHAIN.argtypes)
    dep = _bare("qz_probe_dep", P.DEP.argtypes)
    raw = P._raw_stream(dev)
    gen = torch.Generator().manual_seed(0)
    x = _ints(gen, 0, 1 << 30, (8, 128)).to(dev)
    stream = _u32(gen, (128, 4096)).to(dev)
    off = _ints(gen, 0, 4096 - 128, (128,))
    off_dev = off.to(dev)
    ar = torch.arange(128, device=dev)
    tile = _u32(gen, (128, 128)).to(dev)
    tbl = _ints(gen, 0, 1 << 20, (8, 128)).to(dev)
    idx = _ints(gen, 0, 128, (8, 128)).to(dev)

    def gather():
        return torch.gather(stream, 1, off_dev.to(torch.int64)[:, None] + ar)

    pieces = {
        "ctypes call": lambda: fn(0, None),
        "ctypes call + empty launch": lambda: fn(1, raw),
        "launch_floor wrapper": lambda: P.launch_floor(dev),
        "current_stream().cuda_stream": lambda: torch.cuda.current_stream(
            dev).cuda_stream,
        "raw stream handle": lambda: P._raw_stream(dev),
        "torch.empty [8, 128]": lambda: torch.empty(
            (8, 128), dtype=torch.int32, device=dev),
        "torch.empty_like [8, 128]": lambda: torch.empty_like(x),
        "_on(t, idx)": lambda: P._on(tbl, idx),
        "two contiguous().reshape": lambda: (
            idx.contiguous().reshape(-1, 128), tbl.contiguous().reshape(
                -1, 128)),
        "ctypes 13-argument call, refused": lambda: chain(
            99, 1, None, 0, 0, None, None, 0, 0, 0, 0, None, raw),
        "ctypes 11-argument call, refused": lambda: dep(
            1, None, 0, 0, None, None, 0, 0, 0, None, raw),
        "probe_roll [8, 128] lanes": lambda: P.probe_roll(x, 1, 1),
        "torch.roll [8, 128] lanes": lambda: torch.roll(x, 1, 1),
        "probe_refill 128 lanes ld": lambda: P.probe_refill(stream, off, 128),
        "torch.gather refill 128 lanes": gather,
        "probe_transpose [128, 128]": lambda: P.probe_transpose(tile, 1),
        "x.t() + 1 [128, 128]": lambda: tile.t() + 1,
        "probe_chain dep [8, 128]": lambda: P.probe_chain("dep", tbl, idx, 1),
        "torch.gather [8, 128]": lambda: torch.gather(tbl, 1, idx.long()),
    }
    for label, mod in (others or {}).items():
        pieces[f"{label} probe_transpose [128, 128]"] = (
            lambda mod=mod: mod.probe_transpose(tile, 1))
        pieces[f"{label} probe_chain dep [8, 128]"] = (
            lambda mod=mod: mod.probe_chain("dep", tbl, idx, 1))
    out = {}
    for name, f in pieces.items():
        f()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            f()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) / n * 1e6
    return out


def _tuple(r):
    return r if isinstance(r, tuple) else (r,)


def _inputs(case: Case, dev, seed: int) -> tuple:
    """(the wrapper's inputs, every input on dev) of a case."""
    cpu = case.make(torch.Generator().manual_seed(seed))
    on = tuple(t.to(dev) for t in cpu)
    return tuple(c if i in case.host else d
                 for i, (c, d) in enumerate(zip(cpu, on))), on


def run_case(case: Case, dev, seed: int, floor: dict | None = None) -> dict:
    """Check, time and slope-time one case; returns its record."""
    x, xd = _inputs(case, dev, seed)
    got = _tuple(case.run(x, case.k))
    want = _tuple(case.plain(xd, case.k))
    torch.cuda.synchronize()
    err = 0
    for g, w in zip(got, want, strict=True):
        if not torch.equal(g, w):
            raise AssertionError(f"{case.name}: kernel != plain")
        err = max(err, int((g.to(torch.int64) - w.to(torch.int64))
                           .abs().max()) if g.numel() else 0)
    ms = _time_ms(lambda: case.run(x, case.k), 5)
    g_ms = graph_ms(lambda: case.run(x, case.k), GRAPH_REPS)
    t0 = time.perf_counter()
    case.plain(xd, case.k)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    nbytes, ops = case.work(xd, case.k)
    bytes_ms = nbytes / HBM_BYTES_S * 1e3
    ops_ms = ops / FP32_OPS_S * 1e3
    lib = case.library
    rec = {"name": case.name, "kernel": case.kernel, "route": "cuda",
           "source": case.source,
           "replaces": case.replaces, "path": None, "shape": case.shape,
           "k": case.k, "max_abs_err": err, "ms": ms, "graph_ms": g_ms,
           "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
           "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
           "library_ms": _time_ms(lambda: lib(xd), 5) if lib else None,
           "library_graph_ms": (graph_ms(lambda: lib(xd), GRAPH_REPS)
                                if lib else None),
           "unit": case.units}
    if floor is not None:
        rec.update(launch_floor_ms=floor["ms"],
                   launch_floor_graph_ms=floor["graph_ms"])
    if case.ctas:
        rec.update(ctas=case.ctas, ctas_floor_graph_ms=graph_ms(
            lambda: P.launch_floor(dev, case.ctas), GRAPH_REPS))
    if case.k_lo is not None:
        clk = torch.zeros(CLK_WORDS, dtype=torch.int64, device=dev)
        t_lo = _time_ms(lambda: case.run(x, case.k_lo, clk), 5)
        c_lo = int(clk[0])
        t_hi = _time_ms(lambda: case.run(x, case.k_hi, clk), 5)
        c_hi = int(clk[0])
        dk = case.k_hi - case.k_lo
        rec.update(k_lo=case.k_lo, k_hi=case.k_hi,
                   ns_per_unit=(t_hi - t_lo) / dk * 1e6,
                   clocks_per_unit=(c_hi - c_lo) / dk)
        if case.cluster:
            rec.update(cluster_ctas=case.cluster, sms=len(set(
                clk[1:1 + case.cluster].tolist())))
    return rec


def _ms(v) -> str:
    return "-" if v is None else f"{v:.4f}"


def line(rec: dict) -> str:
    s = (f"probe {rec['name']} ({rec['shape']}): equal to plain at K "
         f"{rec['k']}; kernel {rec['ms']:.4f} ms host-paced, "
         f"{rec['graph_ms']:.4f} graph-replayed; plain {rec['plain_ms']:.4f}"
         f" ms, bound {rec['bound_ms']:.6f} ms ({rec['bound_by']})")
    if rec["library_ms"] is not None:
        s += (f", library call {rec['library_ms']:.4f} host-paced, "
              f"{rec['library_graph_ms']:.4f} graph-replayed")
    if "latency_bound_ms" in rec and "stages" in rec:
        st = rec["stages"]
        s += (f", latency bound {rec['latency_bound_ms']:.6f} ms "
              f"({sum(st.values())} stages x {INT_CLOCKS} clocks = "
              f"{rec['latency_bound_clocks']:.1f}), this design's "
              f"{rec['design_ms']:.6f} ms ({st['regs']} in registers x "
              f"{INT_CLOCKS}, {st['shfl']} shuffles x "
              f"{rec['shfl_clocks']:.1f}, {st['smem']} x a load and a "
              f"barrier {rec['lds_bar_clocks']:.1f}"
              + (f", {st['cluster']} exchanges across CTAs x "
                 f"{rec['exchange_clocks']:.1f}" if "cluster" in st else "")
              + f" = {rec['design_clocks']:.1f} clocks)")
    elif "latency_bound_ms" in rec:
        s += (f", latency bound {rec['latency_bound_ms']:.6f} ms (K x "
              "dependent loads a unit x the dependent load)")
    if "launch_floor_ms" in rec:
        s += (f"; launch floor {rec['launch_floor_ms']:.4f} host-paced, "
              f"{rec['launch_floor_graph_ms']:.4f} graph-replayed")
    if "ctas" in rec:
        s += (f"; an empty kernel of its {rec['ctas']} CTAs "
              f"{rec['ctas_floor_graph_ms']:.4f} graph-replayed")
    if "ns_per_unit" in rec:
        s += (f"; slope K {rec['k_lo']}..{rec['k_hi']}: "
              f"{rec['ns_per_unit']:.3f} ns and "
              f"{rec['clocks_per_unit']:.2f} clocks a {rec['unit']}")
    if "sms" in rec:
        s += f"; a cluster of {rec['cluster_ctas']} CTAs on {rec['sms']} SMs"
    return s


def run(dev=torch.device("cuda", 0), log=print,
        others: dict | None = None, only=None) -> list:
    """Every case on dev (the card unless given; only: the cases' names,
    if given); returns their records, printing a line each, the launch
    floor and the host pieces (beside others' wrappers, as
    :func:`host_pieces`) first.  The dependent load that latency bounds are
    counted in (DEP_LOAD) runs first."""
    floor = launch_floor(dev)
    log(f"probe launch floor (an empty kernel): {floor['ms']:.4f} ms "
        f"host-paced, {floor['graph_ms']:.4f} graph-replayed")
    pieces = host_pieces(dev, others=others)
    log("probe host pieces, us a call: " + ", ".join(
        f"{k} {v:.3f}" for k, v in pieces.items()))
    recs, dep_ns = [], None
    for i in sorted(range(len(CASES)),
                    key=lambda i: CASES[i].name != DEP_LOAD):
        case = CASES[i]
        if only and case.name not in only:
            continue
        recs.append(run_case(case, dev, seed=i, floor=floor))
        if case.name == DEP_LOAD:
            dep_ns = recs[-1]["ns_per_unit"]
        if case.dep_loads and dep_ns is not None:
            recs[-1].update(latency_bound_ms=case.k * case.dep_loads
                            * dep_ns * 1e-6)
        if "seg_n" in case.args:
            recs[-1].update(_sort_bounds(case, recs))
        log(line(recs[-1]))
    return recs


def _sort_bounds(case: Case, recs: list) -> dict:
    """A BITONIC or 64K row case's latency bounds, in clocks and in ms at
    the clock rate the dependent-load case ran at: the least any design
    needs (the network's stages, each one dependent integer instruction),
    and this design's (a stage in registers one instruction, across lanes
    a measured shuffle, across warps a measured dependent load and
    barrier, across CTAs the measured exchange: TRANSPOSE's clocks a step,
    a 16-byte st.async on the partner's mbarrier and its wait); {} without
    the dependent load, shuffle, barrier (and, for a row, TRANSPOSE)
    records of this run."""
    by = {r["name"]: r for r in recs}
    row = bool(case.cluster)
    need = {DEP_LOAD, "probe_alu_shfl", "probe_alu_bar"} | (
        {"probe_tile_transpose"} if row else set())
    if not need <= set(by):
        return {}
    dep = by[DEP_LOAD]
    ghz = dep["clocks_per_unit"] / dep["ns_per_unit"]
    m = case.args["seg_n"]
    st = P.bitonic_plan(m, m)["stages"]
    if row:   # the passes past a CTA's values, across CTAs
        lc = case.cluster.bit_length() - 1
        st["cluster"] = lc * (lc + 1) // 2
        st["smem"] -= st["cluster"]
    shfl = by["probe_alu_shfl"]["clocks_per_unit"]
    lds_bar = dep["clocks_per_unit"] + by["probe_alu_bar"]["clocks_per_unit"]
    least = sum(st.values()) * INT_CLOCKS
    design = (st["regs"] * INT_CLOCKS + st["shfl"] * shfl
              + st["smem"] * lds_bar)
    out = {"stages": st, "latency_bound_clocks": least,
           "latency_bound_ms": case.k * least / ghz * 1e-6,
           "shfl_clocks": shfl, "lds_bar_clocks": lds_bar}
    if row:
        out["exchange_clocks"] = by["probe_tile_transpose"][
            "clocks_per_unit"]
        design += st["cluster"] * out["exchange_clocks"]
    out.update(design_clocks=design, design_ms=case.k * design / ghz * 1e-6)
    return out


def graph_safe(dev, log=print) -> int:
    """The ROLL, REFILL, TRANSPOSE, DEP, COLUMN, STEP3, STEP5, TOKENS,
    INDEP, BITONIC and 64K row sort cases' wrappers under
    ``torch.cuda.set_sync_debug_mode("error")`` (a call that synchronises
    raises), then captured in a CUDA graph and replayed: each result equal
    to plain.  Returns the cases checked."""
    cases = [c for c in CASES if redesigned(c)]
    for i, case in enumerate(cases):
        x, xd = _inputs(case, dev, seed=i)
        want = _tuple(case.plain(xd, case.k))
        torch.cuda.synchronize()
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = _tuple(case.run(x, case.k))
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                captured = _tuple(case.run(x, case.k))
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        torch.cuda.synchronize()
        ok = all(torch.equal(a, w) for a, w in zip(got, want, strict=True))
        for o in captured:
            o.fill_(-1)
        g.replay()
        torch.cuda.synchronize()
        if not (ok and all(torch.equal(b, w)
                           for b, w in zip(captured, want, strict=True))):
            raise AssertionError(f"{case.name}: != plain under sync debug "
                                 "mode or from a graph")
    log(f"probe graph safety: {len(cases)} ROLL, REFILL, TRANSPOSE, DEP, "
        "COLUMN, STEP3, STEP5, TOKENS, INDEP, BITONIC and 64K row sort "
        "cases raise nothing under sync "
        "debug mode \"error\" and replay from a CUDA graph equal to plain")
    return len(cases)


def step_skeleton_ns(recs: list, lanes: int) -> float:
    """The measured STEP5 skeleton at one lane a CTA, ns a step, over the
    inflate's region layout (root 256 + sub 256 cells) at ``lanes``."""
    return next(r["ns_per_unit"] for r in recs
                if r["name"] == f"probe_step_step5_{lanes}l_root256_lpc1")


def dep_load_ns(recs: list) -> float:
    """The measured dependent shared-memory load at the inflate's shape
    (512 lanes, a thread a CTA, 8 KB tables), ns."""
    return next(r["ns_per_unit"] for r in recs if r["name"] == DEP_LOAD)


# -- old against new ----------------------------------------------------------

OUT = os.path.join(os.path.dirname(_build.BUILD_DIR), "probe_bench")


def _load_other(label: str, root: str, lib: str):
    """Another checkout's tools/probes.py, its kernels bound to lib (its
    own probes.cu, built)."""
    path = os.path.join(root, "qatzip_tpu_torch", "tools", "probes.py")
    spec = importlib.util.spec_from_file_location(f"_probes_{label}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    so = ctypes.CDLL(lib)
    for k in mod.KERNELS.values():
        fn = getattr(so, k.symbol)
        fn.argtypes, fn.restype = k.argtypes, ctypes.c_int
        k._fn = fn
    return mod


def build_against(roots: dict) -> dict:
    """{label: checkout root} -> {label: its probes module}; this
    checkout's library through ops/_build, the others' into OUT, one nvcc
    each, all started together."""
    procs = []
    for label, root in roots.items():
        lib = os.path.join(OUT, label, _build.PROBES)
        os.makedirs(os.path.dirname(lib), exist_ok=True)
        src = os.path.join(root, "qatzip_tpu_torch", "tools", "probes.cu")
        procs.append((label, root, lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", src, "-o", lib],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    _build.build(force=True, name=_build.PROBES)
    mods = {}
    for label, root, lib, proc in procs:
        _, err = proc.communicate()
        with open(lib + ".nvcc.log", "w") as f:   # ptxas's report
            f.write(err)
        if proc.returncode:
            raise _build.KernelError(f"nvcc failed for {label}:\n{err}")
        mods[label] = _load_other(label, root, lib)
    mods["this"] = P
    return mods


def _against_cases(only=None) -> list:
    """The cases --against times: ROLL, REFILL, TRANSPOSE, COLUMN, STEP3,
    STEP5, TOKENS, INDEP, BITONIC and the 64K row sort (not its signed
    case, which an older checkout's sort_u32 does not sort), p_gather and
    the two DEP slopes that chip_smoke reads, WALK, HASH, EW and DOUBLE;
    only: their names, if given."""
    return [c for c in CASES
            if ((redesigned(c) and c.kernel != "qz_probe_dep")
                or c.name in AGAINST_DEP + AGAINST_OTHER)
            and c.name not in AGAINST_NOT
            and (not only or c.name in only)]


def _calls(mod, case: Case, x: tuple, xd: tuple):
    """(the wrapper as a caller calls it, a capture-safe call of the same
    kernel) of an --against case in mod; a checkout whose refill reads
    its offsets from the card takes them there, and its wrapper (which
    reads them back) is captured through its launch alone."""
    a = case.args
    if "call" in a:
        def step(K=1, clk=None):
            return a["call"](mod, x, K, clk)
        return step, step
    if case.kernel == "qz_probe_roll":
        def roll(K=1):
            return mod.probe_roll(x[0], a["shift"], a["axis"])
        return roll, roll
    if case.kernel == "qz_probe_transpose":
        def tr(K=1):
            return mod.probe_transpose(x[0], K)
        return tr, tr
    if case.kernel == "qz_probe_dep":
        def dep(K=1):
            return mod.probe_chain("dep", x[0], x[1], K, smem=a["smem"])
        return dep, dep
    offs = x[1] if hasattr(mod, "REFILL") else xd[1]

    def call(K=1):
        return mod.probe_refill(x[0], offs, a["win"], K, alt=a["alt"],
                                how=a["how"])
    if offs is x[1]:
        return call, call
    out = torch.empty((x[0].shape[0], a["win"]), dtype=torch.int32,
                      device=x[0].device)

    def launch(K=1):
        return mod._tile(f"refill_{a['how']}", x[0], out, *x[0].shape, K=K,
                         off=offs, alt=a["alt"], win=a["win"])
    return call, launch


def against(mods: dict, dev, log=print, only=None) -> list:
    """The cases of :func:`_against_cases` through each checkout's wrapper
    and library, in turns (the others, this, this, the others): each equal
    to plain, then host-paced and graph-replayed ms (20 calls each) and,
    where the case has one, the slope over its K_lo..K_hi (5 host-paced
    calls at each) and, for every case but ROLL, REFILL, TRANSPOSE and
    DEP's, the kernel's clock64() ticks a unit over the same K; INDEP's
    and STEP3's also graph-replayed at K 0 (the staging and launch alone);
    only: the cases' names, if given.  Returns a record a case and
    checkout turn."""
    order = list(mods) + list(reversed(mods))
    recs = []
    for case in _against_cases(only):
        x, xd = _inputs(case, dev, seed=CASES.index(case))
        want = _tuple(case.plain(xd, case.k))
        calls = {}
        for label, mod in mods.items():
            call, launch = _calls(mod, case, x, xd)
            got = _tuple(call(case.k))
            if not all(torch.equal(g, w)
                       for g, w in zip(got, want, strict=True)):
                raise AssertionError(f"{label} {case.name} != plain")
            calls[label] = (call, launch)
        cells = []
        for label in order:
            call, launch = calls[label]
            rec = {"name": case.name, "checkout": label,
                   "ms": _time_ms(lambda: call(case.k), 20),
                   "graph_ms": graph_ms(lambda: launch(case.k), GRAPH_REPS)}
            if case.k_lo is not None:
                t = [_time_ms(lambda K=K: call(K), 5)
                     for K in (case.k_lo, case.k_hi)]
                rec["ns_per_unit"] = ((t[1] - t[0]) * 1e6
                                      / (case.k_hi - case.k_lo))
            if "call" in case.args:
                clk = torch.zeros(CLK_WORDS, dtype=torch.int64, device=dev)
                ticks = []
                for K in (case.k_lo, case.k_hi):
                    call(K, clk)
                    torch.cuda.synchronize()
                    ticks.append(int(clk[0]))
                if ticks[1]:   # a route that writes no ticks has none
                    rec["clocks_per_unit"] = ((ticks[1] - ticks[0])
                                              / (case.k_hi - case.k_lo))
            if case.ctas:   # the kernel's fixed part: its staging, launch
                rec["graph_ms_k0"] = graph_ms(lambda: launch(0), GRAPH_REPS)
            recs.append(rec)
            cells.append(f"{label} {rec['ms']:.4f} / {rec['graph_ms']:.4f}"
                         + (f" (K 0: {rec['graph_ms_k0']:.4f})"
                            if "graph_ms_k0" in rec else "")
                         + (f" ({rec['ns_per_unit']:.1f} ns"
                            if "ns_per_unit" in rec else "")
                         + (f", {rec['clocks_per_unit']:.1f} clocks"
                            if "clocks_per_unit" in rec else "")
                         + (")" if "ns_per_unit" in rec else ""))
        log(f"against {case.name} (ms host-paced / graph-replayed (ns"
            f"{', clocks' if 'call' in case.args else ''} a {case.units})): "
            + "; ".join(cells))
    return recs


# -- the step's code ----------------------------------------------------------

# The STEP5 kernel at one lane a CTA, root 256, no tokens, the TOKENS tile
# kernel, the COLUMN kernel over shared memory, the STEP3 kernel, the INDEP
# kernels at R = 32, the BITONIC kernels of the three [8, 128] cases and
# the 64K row sort's at 16 CTAs a row (a trip of its loop: a sort), by
# their mangled names' heads (the STEP5 kernel: a template of its own; an
# older checkout's: qzp_step<1, 0>; COLUMN's staged by tensor copies, or
# by loads (qzp_column<true>), or behind qz_probe_chain before its own
# entry (qzp_chain_column<true>); INDEP's behind qz_probe_chain before its
# own entry (qzp_chain_rows<mode, true>); BITONIC's one kernel for every
# segment before a kernel a segment length) and the HASH, EW and DOUBLE
# chains, and the loads of a step (0: a trip of the loop is a step, a
# sort; an opcode: the instruction a step issues once).
SASS_KERNELS = {
    "step5": (("_Z9qzp_step5I10QzpS5ShapeILi128ELi256ELi256EELi1ELi0EE",
               "_Z8qzp_stepILi1ELi0EE"), 7),
    "tokens tile": (("_Z8qzp_stepILi2ELi2EE",), 1),
    "column": (("_Z14qzp_column_tma", "_Z10qzp_columnILb1EE",
                "_Z16qzp_chain_columnILb1EE"), 1),
    "step3": (("_Z8qzp_stepILi0ELi0EE",), 6),
    "indep4": (("_Z9qzp_indepILi4ELi32EE", "_Z14qzp_chain_rowsILi1ELb1EE"),
               4),
    "indep8": (("_Z9qzp_indepILi8ELi32EE", "_Z14qzp_chain_rowsILi2ELb1EE"),
               8),
    "bitonic flat": (("_Z11qzp_bitonicILi1024EE", "_Z11qzp_bitonic7"), 0),
    "bitonic rows": (("_Z11qzp_bitonicILi128EE",), 0),
    "bitonic cols": (("_Z11qzp_bitonicILi8EE",), 0),
    "bitonic row": (("_Z15qzp_bitonic_row",), 0),
    "hash": (("_Z7qzp_aluILi0EE",), "IMAD"),
    "ew": (("_Z7qzp_aluILi1EE",), "IMAD"),
    "double": (("_Z7qzp_aluILi2EE",), "IMAD"),
}


def sass_functions(lib: str) -> dict:
    """{mangled name: its SASS instructions (address, predicate, opcode,
    operands)} of a library, by cuobjdump; a label line as (None,
    "label", name, "")."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib], check=True,
                          capture_output=True, text=True).stdout
    funcs = {}
    for part in text.split("Function : ")[1:]:
        name, _, body = part.partition("\n")
        ins = []
        for ln in body.splitlines():
            lab = re.match(r"\s*(\.L_x_\d+):", ln)
            m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                          r"([A-Z][\w.]*)\s*([^;]*);", ln)
            if lab:
                ins.append((None, "label", lab.group(1), ""))
            elif m:
                ins.append((int(m.group(1), 16), (m.group(2) or "").strip(),
                            m.group(3), m.group(4)))
        funcs[name.strip()] = ins
    return funcs


_NO_DEST = ("ST", "RED", "BRA", "BAR", "EXIT", "NOP", "RET", "CALL", "BSYNC",
            "BSSY", "WARPSYNC", "MEMBAR", "FENCE", "UBLKCP", "SYNCS", "CCTL",
            "ERRBAR", "DEPBAR")


def _regs(text: str) -> list:
    return re.findall(r"\bU?[RP]\d+\b", text)


def loop_chain(ins: list, unit) -> dict:
    """The loop of a kernel's SASS with the most shared-memory loads (LDS),
    then warp shuffles (SHFL), the innermost of equals: its instructions,
    LDS and SHFL, the steps it holds (unit: LDS a step, an int; one a trip
    where that is 0; or the opcode a step issues once, a str), and its
    longest chain of register dependences carried round the loop
    (instructions an iteration: how much deeper a register is after the
    third copy of the body than after the second, the dependences followed
    through three copies), each a step.  A branch names its target by
    label or by address."""
    loads_per_step = unit if isinstance(unit, int) else 0
    at = {}
    for i, x in enumerate(ins):
        key = x[2] if x[1] == "label" else x[0]
        at.setdefault(key, i)
    best = None
    for j, (_, pred, op, opnds) in enumerate(ins):
        if pred == "label" or not op.startswith("BRA"):
            continue
        tgt = re.search(r"\.L_x_\d+|0x[0-9a-f]+", opnds)
        if not tgt:
            continue
        key = (tgt.group(0) if tgt.group(0).startswith(".")
               else int(tgt.group(0), 16))
        if at.get(key, j) >= j:
            continue
        body = [x[1:] for x in ins[at[key]:j + 1] if x[1] != "label"]
        rank = (sum(1 for x in body if x[1].startswith("LDS")),
                sum(1 for x in body if x[1].startswith("SHFL")), -len(body))
        if best is None or rank > best[1]:
            best = (body, rank)
    if best is None or (loads_per_step and not best[1][0]):
        return {}
    body, (lds, shfl, _) = best
    depth, last = {}, {}   # instruction depth; a register's last writer's
    ends = []   # each copy's {register: its last writer's depth}
    for rep in range(3):
        for i, (pred, op, opnds) in enumerate(body):
            parts = [p.strip() for p in opnds.split(",")]
            ndest = (0 if op.startswith(_NO_DEST)
                     else 2 if (op.startswith(("ISETP", "FSETP", "PLOP3"))
                                or (op.startswith("SHFL")
                                    and parts[0].startswith("P")))
                     and len(parts) > 1 else 1)
            dests = [r for p in parts[:ndest] for r in _regs(p)]
            srcs = _regs(pred) + [r for p in parts[ndest:]
                                  for r in _regs(p)]
            d = 1 + max((depth[last[r]] for r in srcs if r in last),
                        default=0)
            depth[(rep, i)] = d
            for r in dests:
                if r not in ("PT", "RZ"):
                    last[r] = (rep, i)
                    if ".64" in op or ".WIDE" in op:
                        n = int(re.sub(r"\D", "", r))
                        last[r[:-len(str(n))] + str(n + 1)] = (rep, i)
        ends.append({r: depth[w] for r, w in last.items() if w[0] == rep})
    steps = (max(1, lds // loads_per_step) if loads_per_step
             else 1 if not unit
             else max(1, sum(1 for x in body if x[1].startswith(unit))))
    carried = max((d - ends[1][r] for r, d in ends[2].items()
                   if r in ends[1]), default=0)
    return {"instructions": len(body) / steps, "lds": lds / steps,
            "shfl": shfl / steps, "steps_in_loop": steps,
            "chain": carried / steps}


def sass_report(libs: dict, log=print) -> list:
    """loop_chain of each kernel of SASS_KERNELS in each library ({label:
    path}), a line each."""
    recs = []
    for label, lib in libs.items():
        funcs = sass_functions(lib)
        for kind, (heads, loads) in SASS_KERNELS.items():
            name = next((n for h in heads for n in funcs
                         if n.startswith(h)), None)
            if name is None:
                continue
            rec = {"checkout": label, "kernel": kind, "function": name,
                   **loop_chain(funcs[name], loads)}
            recs.append(rec)
            log(f"probe sass {label} {kind} ({name}): "
                + ", ".join(f"{k} {v:.1f}" if isinstance(v, float)
                            else f"{k} {v}" for k, v in rec.items()
                            if k not in ("checkout", "kernel", "function"))
                + " a step")
    return recs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", nargs="*", default=[],
                    help="roots of other checkouts whose ROLL, REFILL, "
                         "TRANSPOSE, DEP, COLUMN, STEP3, STEP5, TOKENS, "
                         "INDEP, BITONIC and the 64K sort to time beside "
                         "this one's")
    ap.add_argument("--only", nargs="*", default=None,
                    help="the cases to time, by name (all)")
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    t0 = time.perf_counter()
    mods = build_against({os.path.basename(os.path.normpath(r)): r
                          for r in args.against})
    print(f"probe build: {time.perf_counter() - t0:.2f} s")
    sass_report({"this": os.path.join(_build.BUILD_DIR, _build.PROBES),
                 **{label: os.path.join(OUT, label, _build.PROBES)
                    for label in mods if mods[label] is not P}})
    dev = torch.device("cuda", 0)
    graph_safe(dev)
    recs = run(dev, others={k: m for k, m in mods.items() if m is not P},
               only=args.only)
    if args.against:
        recs += against(mods, dev, only=args.only)
    print(json.dumps(recs))


if __name__ == "__main__":
    main()
