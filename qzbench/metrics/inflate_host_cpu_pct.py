"""inflate_host_cpu_pct: the thread CPU time of the program's own
``inflate.batch`` spans over their wall time, summed over the window's
requests (%): the rest of the wall its thread waited, for the interpreter
lock, the chunk pool or the device."""
from qzbench import program_spans


def read(run):
    trees = program_spans.request_trees(run)
    spans = [s for t in (trees or {}).values() for s in t
             if s["name"] == "inflate.batch"]
    wall = sum(s["end_ns"] - s["start_ns"] for s in spans)
    if not wall:
        return None
    return 100.0 * sum(s["cpu_ns"] for s in spans) / wall
