"""``hnsw.glue_ms``: device milliseconds a request spends in kernels that
are not the program's hand-written ones (PyTorch's own ops: the beam's
eager glue, the routing's and rescore's torch ops)."""


def read(run):
    tr = run.trace
    if not tr.requests:
        return None
    us = sum(e - s for n, s, e in tr.kernels if not tr.is_handwritten(n))
    return us / len(tr.requests) / 1e3
