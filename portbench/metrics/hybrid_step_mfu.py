"""A hybrid's whole serve step as a share of the card's bf16 peak: the
analytic operations of every prompt and output token served in the span
(``roofline/nemotron_h.py``, through the architecture's file) over the
span's seconds times 989 TFLOP/s, in %, as ``step_mfu`` reads them."""
from portbench import stats
from portbench.roofline import peaks


def read(run):
    flops = sum(s.flops for s in run.steps)
    return flops / (stats.span_s(run) * peaks.BF16_FLOPS) * 100
