"""% of the traced window in which no kernel ran on the card: one minus
the union of kernel intervals over the window."""


def read(run):
    if run.trace is None or not run.trace["window_s"]:
        return None
    return (1 - run.trace["busy_s"] / run.trace["window_s"]) * 100
