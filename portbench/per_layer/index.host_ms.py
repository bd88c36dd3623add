"""``index.host_ms``: the mean, over the requests of the traced window, of
a request's host-clock time outside its ``search_device`` span in which no
device operation ran: the index API's own host work around the device
search (the slot-to-id map ``ids_of``, the download calls, the Python of
``search``). The device search's host gaps (dispatch, a beam's host reads
and launches) lie inside ``search_device`` and are not counted here."""

from portbench.trace import Cover


def read(run):
    tr = run.trace
    if not tr.requests:
        return None
    covered = Cover([*tr.spans["search_device"], *tr.busy.iv])
    host = sum((e - s) - covered.within(s, e) for s, e in tr.requests)
    return host / len(tr.requests) / 1e3
