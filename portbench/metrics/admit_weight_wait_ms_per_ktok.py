"""Host ms the serving thread waited for weights while admitting, per
1000 admitted prompt tokens: the ``wait.weights`` spans inside
``serve.admit`` spans over the spans' ``prompt_tokens``."""
from portbench import programspans


def read(run):
    spans = programspans.window(run)
    if spans is None:
        return None
    waits = programspans.waits_under(spans, "serve.admit")
    tokens = sum(s.attrs.get("prompt_tokens", 0) for s in spans
                 if s.id in waits)
    if not tokens:
        return None
    ns = sum(w.ns for ws in waits.values() for w in ws
             if w.name == "wait.weights")
    return ns / 1e6 / (tokens / 1000)
