"""search.phase1_ms: the card's busy time on the operations launched
inside the program's ``ubis.search.phase1`` spans (the visibility mask
and ``centroid_topk`` over every centroid), per search batch."""
from ubis_bench import program_spans


def read(run):
    ps = program_spans.of(run)
    if not ps or not run.searches or not ps.count("ubis.search.phase1"):
        return None
    return 1e3 * ps.busy_in("ubis.search.phase1") / len(run.searches)
