"""MB (1e6 B) copied host to device per decode iteration in the window:
streamed sub-layers, demanded cold experts and at-use copies alike
(``ContinuousBatcher.iter_moved_bytes``)."""


def read(run):
    n = run.counters["decode_iterations"]
    return run.counters["decode_moved_bytes"] / n / 1e6 if n else None
