"""tick.device_ms: the card's busy time on the operations launched inside
the program's ``ubis.tick`` spans (every phase of the background tick),
per ``ubis.tick`` span."""
from ubis_bench import program_spans


def read(run):
    ps = program_spans.of(run)
    n = ps.count("ubis.tick") if ps else 0
    return 1e3 * ps.busy_in("ubis.tick") / n if n else None
