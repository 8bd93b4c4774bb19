"""queue_wait_ms.poisson (ms, program counter): the scheduler's mean wait
from submit to admission into a slot, over every request of the window
(``SchedulerMetrics.queue_wait_sum / admitted``, not its bounded sample
ring).  Moves first_result_p95_ms."""


def read(run):
    n = run.scheduler.get("admitted", 0)
    if not n:
        return None
    return run.scheduler["queue_wait_sum"] / n * 1e3
