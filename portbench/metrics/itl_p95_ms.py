"""95th percentile of the gaps between consecutive tokens of one
request, pooled over every request, for tokens that arrived in the
window."""
from portbench import stats


def read(run):
    return stats.percentile(stats.gaps_ms(run), 95)
