"""search.readback_ms: the mean duration of the program's
``ubis.search.readback`` spans, one a collected batch: the time the host
waits for a batch's answer to reach it."""
from ubis_bench import program_spans


def read(run):
    ps = program_spans.of(run)
    n = ps.count("ubis.search.readback") if ps else 0
    return 1e3 * ps.seconds("ubis.search.readback") / n if n else None
