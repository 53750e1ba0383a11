"""Process start to the first timed dispatch: imports, the CUDA context,
the kernel library (built on a checkout's first run), inputs and weights
from the seed, and the warm-up of the cell's own shapes."""


def read(run):
    return run.setup_s
