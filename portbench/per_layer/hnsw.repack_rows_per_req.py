"""``hnsw.repack_rows_per_req``: rows of the packed neighbour table that
the window's searches re-gathered, a request: the ``rows`` of the program's
``hnsw.repack`` spans, whole re-packs included."""

from portbench.program import placed


def read(run):
    rows = [s.attrs["rows"] for s in placed(run) or () if s.name == "hnsw.repack"]
    return sum(rows) / len(run.trace.requests) if rows else None
