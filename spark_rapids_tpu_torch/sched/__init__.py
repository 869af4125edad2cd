"""Query scheduling: so far the cancellation tokens and the scheduler's typed
error family (``cancel.py``), which the run loops and the task-retry loop
read. Admission, pools and the scheduler itself come with the scheduler
slice."""
from .cancel import (
    CancelToken,
    LinkedCancelToken,
    QueryCancelledError,
    QueryOverloadedError,
    QueryQueueFull,
    QueryTimeoutError,
    SchedulerError,
)

__all__ = [
    "CancelToken",
    "LinkedCancelToken",
    "QueryCancelledError",
    "QueryOverloadedError",
    "QueryQueueFull",
    "QueryTimeoutError",
    "SchedulerError",
]
