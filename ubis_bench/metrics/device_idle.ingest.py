"""device_idle.ingest: the share of the traced window in which no
operation ran on the card (the ingest cells)."""


def read(run):
    return None if run.trace is None else run.trace.idle_pct()
