"""One run of one benchmark cell.

A cell of ``BENCHMARK.json`` names a configuration (its file, and the
plain reference that file names), a traffic mix (``qzbench/traffic/<name>
.json``) and the chips it needs; each of its metrics is read by
``qzbench/metrics/<name>.py``.  Nothing here names a cell, a
configuration or a metric: a new one is new files and entries.

A run: checks the card, forces the program's device route, makes every
client's input from the seed, opens one session a client, warms up with a
request a client at the cell's own shape, then drives the closed loop for
the window (with ``trace`` the spans and the profiler around it),
checking each output once its request's clock has stopped, then checks
the distinct compress outputs against the plain reference and reads the
metrics.  The program under test is ``qatzip_tpu_torch``, reached through
its public API (the traced run also wraps the internals its per-layer
metrics name).
"""
from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

from qzbench import corpus, traffic as T

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "qzbench")
# the program's failure counters: any rise while a request is in flight
# marks it as having run some part off the device route
FAILOVER_COUNTERS = (
    ("qatzip_tpu_torch.engine.core", "_engine.sw_requests"),
    ("qatzip_tpu_torch.ops.deflate_decode", "failover_lanes"),
    ("qatzip_tpu_torch.ops.lz4_decode", "failover_blocks"),
    ("qatzip_tpu_torch.engine.health", "health.total_failures"),
)
FORBIDDEN = ("jax", "jaxlib", "flax", "qatzip_tpu")
# distinct compress outputs a client's requests may give, each checked by
# the reference after the window; a further one is unchecked, so not correct
MAX_DISTINCT = 8


class NoDevice(RuntimeError):
    """The machine lacks the cards the cell asks for."""


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A cell of ``BENCHMARK.json`` with its files loaded."""

    def __init__(self, bench: dict, name: str, root: str = ROOT):
        work = [w for w in bench["workloads"] if w["name"] == name]
        if not work:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.entry = work[0]
        self.name = name
        self.chips = int(self.entry["chips"])
        cfg = [c for c in bench["configs"]
               if c["name"] == self.entry["config"]]
        if not cfg:
            raise KeyError(f"no config {self.entry['config']!r}")
        with open(os.path.join(root, cfg[0]["file"])) as f:
            self.config = json.load(f)
        with open(os.path.join(root, "qzbench", "traffic",
                               self.entry["traffic"] + ".json")) as f:
            self.traffic = T.validate(json.load(f))
        self.reference = load_module(
            os.path.join(root, self.config["reference"]),
            "qzbench_ref_" + self.config["name"])

        def listed(m):
            return "workloads" not in m or name in m["workloads"]

        self.end_to_end = [m for m in bench["end_to_end"] if listed(m)]
        e2e = {m["name"] for m in self.end_to_end}
        self.per_layer = [
            m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]
        self.readers = {m["name"]: load_module(
            os.path.join(root, "qzbench", "metrics", m["name"] + ".py"),
            "qzbench_metric_" + m["name"].replace(".", "_"))
            for m in self.end_to_end + self.per_layer}

    @property
    def direction(self) -> str:
        return self.traffic["direction"]

    @property
    def request_bytes(self) -> int:
        """The configuration's request size, or the traffic mix's where it
        cuts it further."""
        return int(self.traffic.get("request_bytes")
                   or self.config["request_bytes"])


def load_cell(name: str, root: str = ROOT) -> Cell:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return Cell(json.load(f), name, root)


class Run:
    """What a run measured, for the metric readers."""

    def __init__(self, cell: Cell):
        self.cell = cell
        self.direction = cell.direction
        self.requests: list = []
        self.window_s = 0.0
        self.setup_s = 0.0
        self.init_s = 0.0           # process start to the engine's init
        self.warmup_s = 0.0         # the warm-up requests, all clients
        self.raw_bytes = 0          # uncompressed bytes of all requests
        self.wire_bytes = 0         # compressed bytes of all requests
        self.spans: dict = {}       # name -> [tracing.Span]
        self.launches: list = []    # (symbol, span) of each launch, in order
        self.counted = None         # Kernel.launches' rise over the window
        self.timeline = None        # tracing.DeviceTimeline
        self.peaks: dict = {}       # the card's row of qzbench/peaks.json

    def span_list(self, name: str) -> list:
        return self.spans.get(name, [])

    def launches_match(self) -> bool:
        """Whether the profiler kept a record of every launch of the
        program's kernels in the window: its count, the tracer's and the
        program's ``Kernel.launches`` counters all agree."""
        return (self.timeline is not None
                and len(self.timeline.port_ops()) == len(self.launches)
                == self.counted)

    def device_ops(self) -> list | None:
        """(name, start s, end s, span) of all device work in the window,
        from the profiler's records; None where it lost some of the
        program's launches.  A program kernel's span is its launch's: the
        stream runs the launches in the order they were made, so the i-th
        record is the i-th launch."""
        if not self.launches_match():
            return None
        port = sorted(self.timeline.port_ops(), key=lambda x: x[1])
        return self.timeline.torch_ops() + [
            (name, s, e, launch[1])
            for (name, s, e, _), launch in zip(port, self.launches)]

    def device_s(self, span: str) -> float | None:
        """Device seconds of the work launched inside span ``span``; None
        where none was found or the records are not whole."""
        ops = [e - s for _, s, e, sp in self.device_ops() or [] if sp == span]
        return sum(ops) if ops else None

    def busy_s(self) -> float | None:
        """Seconds of the window in which the device ran anything, by every
        record the profiler kept."""
        if self.timeline is None:
            return None
        from qzbench import stats

        return stats.busy([(s, e) for _, s, e, _ in self.timeline.ops],
                          0.0, self.timeline.window)


def _failover_count() -> int:
    total = 0
    for mod_name, path in FAILOVER_COUNTERS:
        obj = sys.modules.get(mod_name)
        for part in path.split("."):
            obj = getattr(obj, part)
        total += int(obj)
    return total


def _session(qt, config: dict):
    """A session set up from the configuration's ``session`` entry: the
    API function, the params class, its common fields and its own; a
    string "Enum.MEMBER" names a member of an enum of the API."""
    spec = config["session"]

    def value(v):
        if isinstance(v, str) and "." in v:
            enum, member = v.split(".")
            return getattr(getattr(qt, enum), member)
        return v

    common = qt.QzSessionParamsCommon(
        **{k: value(v) for k, v in spec["common"].items()})
    params = getattr(qt, spec["params"])(
        common_params=common,
        **{k: value(v) for k, v in spec["fields"].items()})
    sess = qt.QzSession()
    rc = getattr(qt, spec["setup"])(sess, params)
    if rc != qt.QZ_OK:
        raise RuntimeError(f"{spec['setup']} returned {rc}")
    return sess


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def _peaks(kind: str) -> dict:
    with open(os.path.join(HERE, "peaks.json")) as f:
        return json.load(f)["cards"].get(kind, {})


def _tracer(cell: Cell, torch, on_card: bool):
    """The traced run's tracer, over every span that the cell's metric
    readers and the breakdown declare, installed; and its profiler, not
    yet started."""
    from torch.profiler import ProfilerActivity, profile

    from qzbench import breakdown, tracing

    specs: dict = {}
    for declared in [breakdown.SPANS] + [
            getattr(r, "SPANS", {}) for r in cell.readers.values()]:
        for name, spec in declared.items():
            target, value_fn = (spec if isinstance(spec, tuple)
                                else (spec, None))
            if name in specs and specs[name][0] != target:
                raise ValueError(f"span {name!r} names two targets")
            specs[name] = (target, value_fn or specs.get(name, (0, None))[1])
    tracer = tracing.Tracer(specs, torch, on_card)
    tracer.install()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    try:   # the client threads' ops too, where this torch can
        from torch._C._profiler import _ExperimentalConfig

        prof = profile(activities=acts, experimental_config=(
            _ExperimentalConfig(profile_all_threads=True)))
    except (ImportError, TypeError):
        prof = profile(activities=acts)
    return tracer, prof


def _reference_agrees(ref, out, original: bytes, device, log) -> bool:
    """Whether the plain reference reads compress output ``out`` back to
    ``original``; what it refuses it names on ``log``."""
    try:
        return ref.read(out, device) == original
    except ValueError as exc:
        print(f"the reference refused an output: {exc}", file=log)
        return False


def forbidden_modules() -> list:
    """Modules loaded whose top-level name is one the run may not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _quiet_env(config: dict) -> str:
    """The program's environment for a run: its device route forced, a
    calibration record path that does not exist (so none is read or
    written), the configuration's device instances, no other
    ``QATZIP_TPU_*`` switch from the caller, and torch's kernel caches
    inside the checkout."""
    for k in [k for k in os.environ if k.startswith("QATZIP_TPU_")]:
        del os.environ[k]
    os.environ["QATZIP_TPU_DEVICE"] = "1"
    os.environ["QATZIP_TPU_OVERSUB"] = str(int(config["device_instances"]))
    # any kernel cache torch keeps, at fixed places inside the checkout
    # (the program's own builds go to build/qatzip_tpu_torch/)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(ROOT, "build", "qzbench", sub)
    absent = os.path.join(tempfile.gettempdir(), "qzbench-no-devcal",
                          "devcal.json")
    os.environ["QATZIP_TPU_DEVCAL_PATH"] = absent
    return absent


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             t_process: float, device=None, serve=None, log=sys.stderr):
    """One run of ``cell``; returns (result dict, check lines).

    ``device``: None for the card (``cuda:0``, checked), or a torch device
    the program's plain kernels run on (the tests' CPU runs).  ``serve``:
    None for the program, or a function (direction, client, src) -> an
    object with rc, data, consumed and ext_rc standing in its place (the
    control)."""
    absent = _quiet_env(cell.config)
    import torch

    on_card = device is None
    if on_card:
        if not torch.cuda.is_available():
            raise NoDevice("torch.cuda.is_available() is false")
        if torch.cuda.device_count() < cell.chips:
            raise NoDevice(f"{torch.cuda.device_count()} cards, the cell "
                           f"asks for {cell.chips}")
        device = torch.device("cuda", 0)
    import qatzip_tpu_torch as qt
    from qatzip_tpu_torch.engine import core

    rc = qt.qz_init(qt.QzSession(), device=device)
    if rc not in (qt.QZ_OK, qt.QZ_DUPLICATE):
        raise RuntimeError(f"qz_init returned {rc}")
    init_s = time.perf_counter() - t_process
    eng = core.engine()
    if not eng.hw_present or eng.hw_backend.device.type != device.type:
        raise RuntimeError("the engine is not on the requested device")
    # loaded here, so that FAILOVER_COUNTERS can read them
    from qatzip_tpu_torch.ops import deflate_decode, lz4_decode  # noqa: F401

    mix, config = cell.traffic, cell.config
    nclients = int(mix["clients"])
    nbytes = cell.request_bytes
    chunk = int(config["chunk_bytes"])
    direction = cell.direction
    ref = cell.reference
    # the inputs, from the seed; the reference's encoding of them is its
    # own work, timed apart and kept out of setup_s
    originals = [corpus.build(seed, c, nbytes) for c in range(nclients)]
    t_make = time.perf_counter()
    if direction == "decompress":
        srcs = [ref.make(o, chunk, device) for o in originals]
    else:
        srcs = originals
    make_s = time.perf_counter() - t_make
    sessions = [_session(qt, config) for _ in range(nclients)]
    lock = threading.Lock()
    failures = {"rc": 0, "sw_route": 0, "failover": 0, "consumed": 0}
    expected = (list(originals) if direction == "decompress"
                else [None] * nclients)
    distinct: list[list] = [[] for _ in range(nclients)]   # compress outputs
    wrong = [0]
    unchecked = [0]

    def program(c, src):
        sess = sessions[c]
        if serve is not None:
            return serve(direction, c, src)
        if direction == "compress":
            return qt.qz_compress(sess, src)
        return qt.qz_decompress(sess, src)

    def client_fn(c):
        src = srcs[c]

        def one():
            before = _failover_count()
            region = regions[0]
            if region is None:
                res = program(c, src)
            else:
                with region("request"):
                    res = program(c, src)
            return res, _failover_count() > before

        return one

    def check(c, returned):
        """A request's outcome, judged after its clock stopped: (the kind
        of failure or None, its input bytes, its output bytes)."""
        src = srcs[c]
        res, rose = returned
        bad = None
        if res.rc != qt.QZ_OK:
            bad = "rc"
        elif res.ext_rc & qt.QZ_SW_EXECUTION_MASK:
            bad = "sw_route"
        elif rose:
            bad = "failover"
        elif res.consumed != len(src):
            bad = "consumed"
        out = res.data
        tag = None
        if bad is not None:
            with lock:
                failures[bad] += 1
        elif direction == "decompress":
            if out != expected[c]:
                with lock:
                    wrong[0] += 1
        else:
            # a compress output equal to one the reference checks
            # after the window is checked with it
            for k, d in enumerate(distinct[c]):
                if out == d[0]:
                    tag = k
                    break
            else:
                if len(distinct[c]) < MAX_DISTINCT:
                    distinct[c].append([out, 0])
                    tag = len(distinct[c]) - 1
                else:
                    with lock:
                        unchecked[0] += 1
        if tag is not None:
            with lock:
                distinct[c][tag][1] += 1
        return (bad, len(src), len(out) if out is not None else 0)

    regions = [None]      # the tracer's region, in the traced window
    fns = [client_fn(c) for c in range(nclients)]
    # warm-up: requests at the cell's shape, every client at once
    warm_bad = 0
    t_warm = time.perf_counter()
    for _ in range(int(mix["warmup_requests"])):
        warm_bad += sum(w[0] is not None
                        for w in T.run_all_once(fns, check))
    warmup_s = time.perf_counter() - t_warm
    for c in range(nclients):
        for d in distinct[c]:
            d[1] = 0          # warm-up outputs stay, their counts do not
    with lock:
        warm_failures = dict(failures)
        for k in failures:
            failures[k] = 0
        warm_wrong = wrong[0]
        wrong[0] = 0

    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    run = Run(cell)
    on_start = None
    if trace:
        from qzbench import breakdown

        tracer, prof = _tracer(cell, torch, on_card)
        regions[0] = tracer.region
        launches0 = breakdown.kernel_launches()
        prof.__enter__()
        marker = torch.profiler.record_function("qzb.window")

        def on_start():
            marker.__enter__()
            tracer.zero()
    setup_s = None

    def start():
        nonlocal setup_s
        if on_start is not None:
            on_start()
        setup_s = time.perf_counter() - t_process - make_s
        cpu0[0] = sum(os.times()[:2])

    cpu0 = [0.0]

    requests, w0, w1 = T.closed_loop(fns, seconds, on_start=start,
                                     check=check)
    cpu_s = sum(os.times()[:2]) - cpu0[0]
    if on_card:
        torch.cuda.synchronize()
    if trace:
        marker.__exit__(None, None, None)
        tracer.uninstall()
        prof.__exit__(None, None, None)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    run.requests = requests
    run.window_s = w1 - w0
    run.setup_s = setup_s
    run.init_s = init_s
    run.warmup_s = warmup_s
    run.raw_bytes = sum(r.result[1] for r in requests) if direction == \
        "compress" else sum(len(expected[r.client]) for r in requests)
    run.wire_bytes = sum(r.result[2] for r in requests) if direction == \
        "compress" else sum(r.result[1] for r in requests)
    kind = torch.cuda.get_device_name(0) if on_card else str(device)
    run.peaks = _peaks(kind)
    if trace:
        from qzbench import tracing

        for s in tracer.spans:
            run.spans.setdefault(s.name, []).append(s)
        run.launches = list(tracer.launches)
        now = breakdown.kernel_launches()
        run.counted = sum(now[k] - launches0.get(k, 0) for k in now)
        run.timeline = tracing.DeviceTimeline(prof, torch, tracer) \
            if on_card else None
    # the program's state goes before the reference runs
    for s in sessions:
        qt.qz_close(s)
    del sessions
    if on_card:
        torch.cuda.empty_cache()
    # the reference checks each distinct compress output
    t_ref = time.perf_counter()
    for c in range(nclients):
        for out, count in distinct[c]:
            if not _reference_agrees(ref, out, originals[c], device, log):
                wrong[0] += count
                if count == 0:       # made by a warm-up request alone
                    warm_wrong += 1
    ref_s = time.perf_counter() - t_ref
    attempted = len(requests)
    failed = sum(r.result[0] is not None for r in requests)
    checks = {
        "failed_requests": (failed, 0),
        "wrong_outputs": (wrong[0], 0),
        "unchecked_outputs": (unchecked[0], 0),
        "warmup_failed_or_wrong": (warm_bad + warm_wrong, 0),
        "requests": (attempted, "> 0"),
    }
    correct = (attempted > 0 and failed == 0 and wrong[0] == 0
               and unchecked[0] == 0 and warm_bad + warm_wrong == 0)
    metrics = {}
    wanted = cell.per_layer if trace else cell.end_to_end
    for m in wanted:
        v = cell.readers[m["name"]].read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev_out = {"platform": "gpu" if on_card else device.type,
               "kind": kind, "count": cell.chips if on_card else 1,
               "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev_out}
    if trace and run.timeline is not None:
        from qzbench import breakdown

        dev_out["busy_s"] = run.busy_s()
        dev_out["window_s"] = run.timeline.window
        result["breakdown"] = breakdown.build(run)
        breakdown.report(run, launches0, log)
        print(f"card: {_power_limit()}", file=log)
    lat = sorted(r.seconds for r in requests) or [0.0]
    # requests completed in each tenth of the window: whether a run's
    # rate moves inside it, or only from run to run
    tenths = [0] * 10
    for r in requests:
        tenths[min(9, int(10 * (r.end - w0) / max(run.window_s, 1e-9)))] += 1
    print(f"run: seed {seed}, window {run.window_s:.4f} s, {attempted} "
          f"requests (seconds: min {lat[0]:.4f}, median "
          f"{lat[len(lat) // 2]:.4f}, max {lat[-1]:.4f}; by client "
          f"{[sum(r.client == c for r in requests) for c in range(nclients)]}"
          f"; ended in each tenth of the window {tenths}), setup "
          f"{setup_s:.4f} s (init {init_s:.4f}, warm-up {warmup_s:.4f}), "
          f"the reference's encoding of the inputs "
          f"{make_s:.4f} s (not in setup), reference {ref_s:.4f} s, "
          f"failures by kind {failures}, warm-up {warm_failures}, distinct "
          f"compress outputs {[len(d) for d in distinct]}, the process's CPU "
          f"seconds in the window {cpu_s:.2f}, no calibration "
          f"record at {absent}: {not os.path.exists(absent)}", file=log)
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result, checks
