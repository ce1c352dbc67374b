"""init_import_s: the program's own ``setup.import`` phase, the import of
``qatzip_tpu_torch`` from the top of its ``__init__.py`` to its end
(torch's import and the native codec's build-or-load inside it); a part of
init_s (s)."""
from qzbench import program_spans


def read(run):
    return program_spans.setup_s({"setup.import"}) or None
