"""step_ms.bulk (ms, program span): the mean duration of the
``service.step`` spans (one batch: the forward enqueued, run and read
back to the host) that the program's tracer recorded over the whole
window.  Moves images_per_s."""


def read(run):
    if run.tracer_dropped:
        raise RuntimeError(
            f"the tracer dropped {run.tracer_dropped} events: step_ms "
            "would read a part of the window")
    if not run.step_spans:
        return None
    return sum(run.step_spans) / len(run.step_spans) * 1e3
