"""setup_s: process start to the window's start (imports, the stream,
the build, the load, the warm-up step; the kernel build in a checkout's
first run)."""


def read(run):
    return run.setup_s
