"""setup_s: seconds from the start of the run's process to the first
request: imports, the card, the inputs, the program's tables and kernels
(built on a checkout's first run), the warm-up."""


def read(run):
    return run.setup_s
