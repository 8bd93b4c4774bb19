"""images_per_s (images/s, host clock): every image the window
completed, over the window's seconds (from its start to the end of its
last step).  Backlog mixes only."""


def read(run):
    win = run.window
    if win.due is not None or win.seconds <= 0:
        return None
    return win.images / win.seconds
