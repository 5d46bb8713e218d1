"""Host ms of a decode pass that the serving thread spent neither
waiting for weights nor for a device result: the mean ``serve.decode``
span less its ``wait.weights`` and ``wait.device`` spans (the port's own
spans, ``repro_torch.core.trace``, recorded in a traced run)."""
from portbench import programspans


def read(run):
    parts = programspans.decode_parts(run)
    if parts is None:
        return None
    n, total, weights, device = parts
    return (total - weights - device) / n / 1e6
