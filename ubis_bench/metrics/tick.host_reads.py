"""tick.host_reads: the device-to-host copies launched inside the
program's ``ubis.tick`` spans, per ``ubis.tick`` span: the reads that
hold the host while the card waits."""
from ubis_bench import program_spans


def read(run):
    ps = program_spans.of(run)
    n = ps.count("ubis.tick") if ps else 0
    return ps.copies_in("ubis.tick") / n if n else None
