"""setup_s (s, host clock): from the start of the run's process to the
window's start: imports, the CUDA context, the seeded network and images,
the compile, the kernels' build on a checkout's first run, and the
warm-up of the one batch shape."""


def read(run):
    return run.setup_s
