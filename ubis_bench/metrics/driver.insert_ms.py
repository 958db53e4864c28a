"""driver.insert_ms: the driver's own ``insert_time`` in the window
(its span ends in a device sync) per 1,000 acknowledged inserts."""


def read(run):
    n = run.stats.get("inserted", 0.0)
    return 1e6 * run.stats["insert_time"] / n if n else None
