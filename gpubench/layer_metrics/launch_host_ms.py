"""``launch_host_ms`` (layer: entry and dispatch): the median over the
traced window's calls of the host time in the program's ``savgol.launch``
spans: library lookup, device guard, stream query and the foreign call
that enqueues each kernel (``spans.host_split``). Read under the profiler,
so it carries its cost."""

from gpubench import spans

UNIT = "ms"


def read(ctx: dict):
    return spans.median_ms(ctx, "launch")
