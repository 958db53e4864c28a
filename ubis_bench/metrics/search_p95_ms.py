"""search_p95_ms: the 95th percentile, over every search batch of the
window, of the time from dispatch to collected answer; a batch that
raised counts as missing, waiting the whole window."""
import numpy as np


def read(run):
    if not run.searches:
        return None
    lat = [b["latency"] if b["ids"] is not None else run.window_s
           for b in run.searches]
    return 1e3 * float(np.percentile(lat, 95))
