"""``launches_per_call`` (layer: entry and dispatch): the card's
operations (kernels, copies, fills) launched inside a call's ``enqueue``
span, by the launch's correlation id, over the traced window's calls."""

from gpubench import trace

UNIT = "ops"


def read(ctx: dict):
    got = trace.per_call(ctx)
    return None if got is None else got[1] / got[0]
