"""Process start to the first timed submit: imports, the CUDA context,
the designs drawn on the device, the program started, every shape warmed
up, and on a checkout's first run the kernels' build."""


def read(run):
    return run.setup_s
