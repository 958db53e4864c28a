"""update_vps: acknowledged inserts plus deletes done in the window, over
the window's seconds."""


def read(run):
    return (run.acked + run.deleted) / run.window_s if run.steps else None
