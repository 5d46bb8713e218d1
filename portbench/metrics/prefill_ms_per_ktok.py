"""Admission cost per 1000 prompt tokens: the time of the steps that
admitted requests, less a decode step's mean time for each, over the
prompt tokens they admitted."""
from portbench import stats


def read(run):
    d = stats.decode_step_ms(run)
    adm = [s for s in run.steps if s.admitted]
    tok = sum(s.admitted_tokens for s in adm)
    if d is None or not tok:
        return None
    t = sum((s.t1_ns - s.t0_ns) / 1e6 for s in adm) - d * len(adm)
    return t / (tok / 1000)
