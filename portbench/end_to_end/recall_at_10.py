"""``recall_at_10``: the share of the exact top-10 (float64 reference)
that the judged answers of the window hold, pooled over all of them."""


def read(run):
    miss = run.numbers.get("miss_at_10")
    return None if miss is None else 1.0 - miss
