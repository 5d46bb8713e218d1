"""K1's share of its roofline: the sum of each K1 call's least time (the
frozen hand count: bytes over the HBM rate or operations over the
dtype's peak, the larger) over K1's device time in the trace, in %."""
from portbench.roofline import work


def read(run):
    if run.trace is None or not run.trace["k1_s"] or not run.k1_calls:
        return None
    bound = sum(work.k1_bound_s(M, K, N, dt) for M, K, N, dt in run.k1_calls)
    return bound / run.trace["k1_s"] * 100
