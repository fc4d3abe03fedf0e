"""Runtime helpers of the port: ``-debug`` tracing and stage timing."""

from mercat2_tpu_torch.utils.runtime import DebugTrace, StageTimer, mem_use

__all__ = ["DebugTrace", "StageTimer", "mem_use"]
