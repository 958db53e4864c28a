"""insert.device_ms: the card's busy time on the operations launched
inside the program's ``ubis.insert.round`` spans, per 1,000 acknowledged
inserts (``driver.insert_ms``'s base)."""
from ubis_bench import program_spans


def read(run):
    ps = program_spans.of(run)
    n = run.stats.get("inserted", 0.0)
    if not ps or not n or not ps.count("ubis.insert.round"):
        return None
    return 1e6 * ps.busy_in("ubis.insert.round") / n
