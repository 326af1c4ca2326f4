"""``apply_self_ms`` (layer: entry and dispatch): the median over the
traced window's calls of the host time inside the program's outermost
``savgol.apply`` span that no ``savgol.taps`` or ``savgol.launch`` span
covers: routing, checks, the ``autograd.Function``, output allocation
(``spans.host_split``). Read under the profiler, so it carries its
cost."""

from gpubench import spans

UNIT = "ms"


def read(ctx: dict):
    return spans.median_ms(ctx, "self")
