from repro_torch.runtime.fault import (PreemptionGuard, StepWatchdog,
                                       retry_transient)

__all__ = ["PreemptionGuard", "StepWatchdog", "retry_transient"]
