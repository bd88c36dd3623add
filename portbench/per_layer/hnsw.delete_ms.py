"""``hnsw.delete_ms``: host milliseconds a request spends in the program's
``index.delete`` spans (the marks, the host reads of the affected rows and
the repair pool, the repair), from the spans' own durations."""

from portbench.program_writes import ms_per_request


def read(run):
    return ms_per_request(run, "index.delete")
