"""``p95_ms``: the 95th percentile of the latency of every request of the
window, each timed on the host clock around one ``search`` call, from its
numpy queries to its numpy answers."""

import numpy as np


def read(run):
    return float(np.percentile(run.latencies, 95) * 1e3) if run.latencies else None
