"""recall10: mean recall@10 of the window's sampled queries against the
reference's exact top-10 over the live set at each search."""


def read(run):
    return run.checks.get("recall10") if run.searches else None
