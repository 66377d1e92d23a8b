from paramugsy_tpu_torch.runtime.scheduler import PriorityScheduler
from paramugsy_tpu_torch.runtime.executor import JobExecutor

__all__ = ["PriorityScheduler", "JobExecutor"]
