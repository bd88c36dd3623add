"""``ops.kernels_per_req``: device kernels (copies and memsets left out)
launched in the traced window, per request."""


def read(run):
    tr = run.trace
    return len(tr.kernels) / len(tr.requests) if tr.requests else None
