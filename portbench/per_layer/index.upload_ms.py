"""``index.upload_ms``: host milliseconds a request spends in the program's
``index.upload`` spans, the copy of the queries to the card."""

from portbench.program import placed


def read(run):
    spans = placed(run)
    if spans is None:
        return None
    us = sum(s.end - s.start for s in spans if s.name == "index.upload")
    return us / len(run.trace.requests) / 1e3
