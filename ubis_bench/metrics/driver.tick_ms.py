"""driver.tick_ms: the driver's own ``bg_time`` in the window over the
ticks the benchmark called (the span ends at the tick's last host read)."""


def read(run):
    return 1e3 * run.stats["bg_time"] / run.ticks if run.ticks else None
