"""``store.slot_waste``: slots held above the live rows, (high watermark -
live) / live in %, when the window's last ``index.insert`` span ended (its
``high_watermark`` and ``live``)."""

from portbench.program_writes import window_spans


def read(run):
    spans = window_spans(run, "index.insert")
    if spans is None or "live" not in spans[-1].attrs:
        return None
    a = spans[-1].attrs
    return 100.0 * (a["high_watermark"] - a["live"]) / a["live"] if a["live"] else None
