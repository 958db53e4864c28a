"""search.device_ms: the card's busy time on the operations launched in
the benchmark's search spans (``search.dispatch``, ``search.collect``),
per search batch of the traced window."""

SEARCH = ("search.dispatch", "search.collect")


def read(run):
    if run.trace is None or not run.searches:
        return None
    busy = run.trace.busy_s(SEARCH)
    return 1e3 * busy / len(run.searches) if busy > 0 else None
