"""``flat_topk_mma_roofline``: ``kernels/flat_topk_mma.py``'s bound over
the time of the tensor-core kernel's launches in the traced window."""


def read(run):
    return run.roofline("flat_topk_mma")
