"""Device kernels in the traced window (torch.profiler) per serve
step."""


def read(run):
    if run.trace is None or not run.steps:
        return None
    return run.trace["kernels"] / len(run.steps)
