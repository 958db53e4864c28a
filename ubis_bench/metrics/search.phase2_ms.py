"""search.phase2_ms: the card's busy time on the operations launched
inside the program's ``ubis.search.phase2`` spans (the float scan, or the
tables, ADC scan and rerank, with the id gather), per search batch."""
from ubis_bench import program_spans


def read(run):
    ps = program_spans.of(run)
    if not ps or not run.searches or not ps.count("ubis.search.phase2"):
        return None
    return 1e3 * ps.busy_in("ubis.search.phase2") / len(run.searches)
