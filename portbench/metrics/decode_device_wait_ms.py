"""Host ms per decode pass that the serving thread waited for a device
result: the ``wait.device`` spans inside ``serve.decode`` spans (the
sampled tokens' read-back, an MoE route, a paged pass's positions), over
the decode passes."""
from portbench import programspans


def read(run):
    parts = programspans.decode_parts(run)
    if parts is None:
        return None
    n, _, _, device = parts
    return device / n / 1e6
