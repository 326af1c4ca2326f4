"""``pad_device_share`` (layer: boundary pad): the share, in %, of the
traced window's calls' device time taken by the operations launched
inside the program's ``savgol.pad`` spans (a pad made outside any kernel:
``scipy_compat``'s ``mirror`` and ``constant`` modes), each operation
matched to the span open at its launch by the launch's correlation id, as
``trace.launched_in`` matches operations to calls. 0 where the calls hold
a ``savgol.apply`` but no pad; nothing where the trace holds no
``savgol.apply`` (a program that records no spans)."""

from gpubench import spans, trace

PAD = "savgol.pad"
UNIT = "%"


def read(ctx: dict):
    if spans.applies_by_call(ctx) is None:
        return None
    events = ctx["events"]
    calls = [e for group in trace.launched_in(events, ctx["calls"])
             for e in group]
    total = sum(e["dur"] for e in calls)
    if not total:
        return None
    pads = spans.union(trace.spans(events, PAD))
    padded = {id(e) for group in trace.launched_in(events, pads)
              for e in group}
    return 100.0 * sum(e["dur"] for e in calls if id(e) in padded) / total
