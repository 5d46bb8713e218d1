"""Host ms of admission spent in the Mamba-2 sub-layers per 1000
admitted prompt tokens: the ``sub.mamba`` spans inside ``serve.admit``
spans over the admissions' ``prompt_tokens``."""
from portbench import mambaspans


def read(run):
    found = mambaspans.mamba_under(run, "serve.admit")
    if found is None:
        return None
    admits, ns = found
    tokens = sum(s.attrs.get("prompt_tokens", 0) for s in admits)
    if not tokens:
        return None
    return ns / 1e6 / (tokens / 1000)
