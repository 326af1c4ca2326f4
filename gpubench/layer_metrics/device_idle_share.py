"""``device_idle_share`` (layer: device): the share of the traced window
(from its first submission to the return of its last wait) in which the
card ran none of the operations launched in it (``trace.idle_share``, the
arithmetic of ``chip_smoke.py::idle_share``)."""

from gpubench import trace

UNIT = "%"


def read(ctx: dict):
    if ctx["window"] is None:
        return None
    t0, t1 = ctx["window"]
    ops = trace.launched_in(ctx["events"], [(t0, t1)])[0]
    return 100.0 * trace.idle_share(ops, t0, t1) if ops else None
