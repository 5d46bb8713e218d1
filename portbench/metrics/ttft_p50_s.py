"""Median time to first token: the token's arrival minus the moment the
client sent the request, over every request whose first token arrived in
the window."""
from portbench import stats


def read(run):
    return stats.percentile(stats.ttfts_s(run), 50)
