"""Bytes moved host to device in the window (ExecStats.staged_bytes),
per second, as a % of PCIe Gen5 x16's published rate in one direction."""
from portbench import stats
from portbench.roofline import peaks


def read(run):
    return run.counters["staged_bytes"] / stats.span_s(run) \
        / peaks.PCIE5_X16_BYTES_S * 100
