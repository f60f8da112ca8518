from topopt_in_petsc_tpu.utils.timers import Timer, timed
from topopt_in_petsc_tpu.utils.profiling import trace_to

__all__ = ["Timer", "timed", "trace_to"]
