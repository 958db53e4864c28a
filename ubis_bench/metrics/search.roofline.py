"""search.roofline: the least time the H100 could take for the search work
of the traced batches (``roofline.search_batch``), as a share of the
card's busy time on them (``search.device_ms``'s)."""
from ubis_bench import roofline

SEARCH = ("search.dispatch", "search.collect")


def read(run):
    if run.trace is None:
        return None
    done = [b for b in run.searches
            if b["ids"] is not None and b["probe"] is not None]
    busy = run.trace.busy_s(SEARCH)
    if not done or busy <= 0 or len(done) != len(run.searches):
        return None
    work = roofline.Work()
    for b in done:
        work = work + roofline.search_batch(run.index, b["queries"],
                                            b["probe"], b["ids"])
    return 100.0 * work.seconds() / busy
