"""Host ms per decode pass that the serving thread waited for weights:
the ``wait.weights`` spans inside ``serve.decode`` spans (a streamed
sub-layer's copy not landed yet, a demanded shard, an at-use copy and
the wait for the previous at-use reader), over the decode passes."""
from portbench import programspans


def read(run):
    parts = programspans.decode_parts(run)
    if parts is None:
        return None
    n, _, weights, _ = parts
    return weights / n / 1e6
