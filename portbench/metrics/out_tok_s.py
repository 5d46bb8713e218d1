"""Output tokens delivered in the window over the window's seconds."""
from portbench import stats


def read(run):
    return stats.tokens_in_window(run) / run.seconds
