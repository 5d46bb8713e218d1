"""Qwen3-MoE: the Qwen3 file, whose sizes take the experts from the
configuration's ``num_experts``."""
from portbench.arch.qwen3 import *  # noqa: F401,F403
