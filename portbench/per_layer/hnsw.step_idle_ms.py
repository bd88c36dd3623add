"""``hnsw.step_idle_ms``: device-idle milliseconds a request inside the
program's ``hnsw.beam_step`` spans, one a step of the fused beam: the
step's host read of its flag and its launches together."""

from portbench.program import placed


def read(run):
    spans = placed(run)
    steps = [s for s in spans or () if s.name == "hnsw.beam_step"]
    if not steps:
        return None
    busy = run.trace.busy
    idle = sum((s.end - s.start) - busy.within(s.start, s.end) for s in steps)
    return idle / len(run.trace.requests) / 1e3
