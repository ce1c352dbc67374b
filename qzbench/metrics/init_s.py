"""init_s: seconds from the process's start to the engine's init
(``qz_init`` returned): the imports, the card's context and, in a
checkout's first run, the program's builds; a part of setup_s."""


def read(run):
    return run.init_s or None
