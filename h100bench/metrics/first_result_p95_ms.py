"""first_result_p95_ms (ms, host clock): the 95th percentile, over every
request due in the window (the drain included), of the time from when it
was due to when the host held its logits.  Open-loop mixes only."""

import numpy as np


def read(run):
    win = run.window
    if win.due is None or win.done is None or win.done.size == 0:
        return None
    return float(np.percentile(win.done - win.due, 95)) * 1e3
