"""setup_s (s): process start to the first timed call: imports, the
CUDA context, the inputs made from the seed, the kernels loaded (built on
the first run of a checkout) and the warm-up of the cell's shapes."""


def read(run):
    return run.setup_s
