"""``qps``: every query answered in the window over the window's seconds
(host clock, from the first request's start to the last one's end)."""


def read(run):
    return run.answered / run.window_s if run.window_s > 0 else None
