"""The card's ms per decode pass spent on host-to-device weight copies:
the ``device_ns`` (a pair of CUDA events around the copy on its stream)
of every ``copy.h2d`` span, of any thread, that starts inside a
``serve.decode`` span, over the decode passes."""
from portbench import programspans


def read(run):
    got = programspans.copy_ns_in_decode(run)
    if got is None:
        return None
    n, ns = got
    return ns / n / 1e6
