"""Set-up: process start to the first timed request (loading, the
traffic pool, the warm-up that builds kernels and captures graphs), s."""


def read(run):
    return run.setup_s
