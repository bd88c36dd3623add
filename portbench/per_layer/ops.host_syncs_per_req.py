"""``ops.host_syncs_per_req``: the mean, over the window's ``index.search``
spans, of their ``host_syncs``: the host reads (``tracing.host_read``) a
search made, its result downloads and, in HNSW, the beam's flag a step."""

from portbench.program import SEARCH, placed


def read(run):
    spans = placed(run)
    if spans is None:
        return None
    syncs = [s.attrs["host_syncs"] for s in spans if s.name == SEARCH]
    return sum(syncs) / len(syncs)
