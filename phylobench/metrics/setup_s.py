"""Set-up seconds: process start to the first timed request (data,
partition, tables, warm-up; in a checkout's first run, the build)."""


def read(run):
    return run.setup_s
