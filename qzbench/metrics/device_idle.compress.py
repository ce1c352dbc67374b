"""device_idle.compress: the share of the traced window in which no
operation ran on the card (%): 100 (1 - busy / window); read only where the
profiler kept a record of every launch of the program's kernels."""


def read(run):
    busy = run.busy_s()
    if run.direction != "compress" or busy is None \
            or not run.launches_match():
        return None
    return 100.0 * (1.0 - busy / run.timeline.window)
