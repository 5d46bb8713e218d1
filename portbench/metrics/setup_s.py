"""Seconds from process start to the first timed request: weights drawn
and pinned, plan, executor, warm-up (and kernel builds on a checkout's
first run)."""


def read(run):
    return run.setup_s
