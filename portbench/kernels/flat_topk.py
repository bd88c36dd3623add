"""``csrc/flat_topk.cu`` in its f32 (``highest``) mode: one launch per
``FlatIndex`` search, every query of the request against every stored row.

Operations: a multiply and an add per query, row and dimension. Bytes:
each input read once (queries, rows, the query norms, the rows' penalty
and inverse-norm rows) and each output written once (a distance and an
id per query and rank)."""

NAME = "flat_topk_kernel"  # the kernel's name in the device trace
PEAK = "fp32"


def work(p: dict) -> tuple[float, float]:
    b, n, d, k = p["queries_per_request"], p["rows"], p["dim"], p["k"]
    ops = 2.0 * b * n * d
    nbytes = 4.0 * (b * d + n * d + b + 2 * n) + 8.0 * b * k
    return ops, nbytes
