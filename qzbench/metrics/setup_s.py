"""setup_s: seconds from the process's start to the window's start:
imports, the card's context, the inputs, the sessions and the warm-up
(and, in a checkout's first run, the program's builds)."""


def read(run):
    return run.setup_s
