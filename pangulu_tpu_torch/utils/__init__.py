from pangulu_tpu_torch.utils.log import get_logger
from pangulu_tpu_torch.utils.perf import PerfCounters, device_sync

__all__ = ["PerfCounters", "get_logger", "device_sync"]
