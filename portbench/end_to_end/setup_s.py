"""``setup_s``: from the start of the harness's process (its first line)
to the first timed request: imports, the data made on the card, the index
built, kernels built or loaded, and the warm-up requests."""


def read(run):
    return run.setup_s
