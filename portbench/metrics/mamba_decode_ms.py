"""Host ms of a decode pass spent in the Mamba-2 sub-layers: the
``sub.mamba`` spans inside ``serve.decode`` spans, summed, over the
passes (the port's spans, recorded in a traced run)."""
from portbench import mambaspans


def read(run):
    found = mambaspans.mamba_under(run, "serve.decode")
    if found is None:
        return None
    passes, ns = found
    return ns / len(passes) / 1e6
