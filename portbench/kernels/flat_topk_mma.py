"""``csrc/flat_topk_mma.cu`` in its s8 mode, as ``FlatIndex`` at
``precision="int8_rescored"`` launches it: one launch per search, the
request's int8 queries against the int8 shadow of every stored row, keeping
``rescore_r`` candidates a query.

Operations: a multiply and an add per query, row and dimension, at the
int8 peak. Bytes: each input read once (int8 queries and rows, the rows'
scales and penalty row) and each output written once (a value and an id
per query and candidate)."""

NAME = "flat_topk_mma_kernel"
PEAK = "int8"


def work(p: dict) -> tuple[float, float]:
    b, n, d, r = p["queries_per_request"], p["rows"], p["dim"], p["rescore_r"]
    ops = 2.0 * b * n * d
    nbytes = 1.0 * (b * d + n * d) + 8.0 * n + 8.0 * b * r
    return ops, nbytes
