"""``flat_topk_roofline``: ``kernels/flat_topk.py``'s bound over the time
of the f32 kernel's launches in the traced window."""


def read(run):
    return run.roofline("flat_topk")
