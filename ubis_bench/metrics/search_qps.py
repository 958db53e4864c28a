"""search_qps: every query answered in the window over the window's seconds."""


def read(run):
    answered = sum(b["queries"] for b in run.searches if b["ids"] is not None)
    return answered / run.window_s if run.searches else None
