"""``taps_host_ms`` (layer: entry and dispatch): the median over the
traced window's calls of the host time in the program's ``savgol.taps``
spans: the taps' dtype cast, the ``dt_inv`` or scale fold,
``.contiguous()`` (``spans.host_split``). Read under the profiler, so it
carries its cost."""

from gpubench import spans

UNIT = "ms"


def read(ctx: dict):
    return spans.median_ms(ctx, "taps")
