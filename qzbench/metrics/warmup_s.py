"""warmup_s: seconds of the warm-up, a request a client at the cell's
shape, all clients at once: the program's first requests, with whatever
it loads or prepares on first use; a part of setup_s."""


def read(run):
    return run.warmup_s or None
