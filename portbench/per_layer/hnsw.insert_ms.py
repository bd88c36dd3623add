"""``hnsw.insert_ms``: host milliseconds a request spends in the program's
``index.insert`` spans (the waves: slots, candidates, wiring, the MN-RU
prune), from the spans' own durations."""

from portbench.program_writes import ms_per_request


def read(run):
    return ms_per_request(run, "index.insert")
