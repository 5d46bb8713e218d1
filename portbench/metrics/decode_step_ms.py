"""Host ms of a serve step that admitted nothing (one fused decode pass
over the active slots): the total of such steps over their count."""
from portbench import stats


def read(run):
    return stats.decode_step_ms(run)
