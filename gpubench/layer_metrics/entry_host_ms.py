"""``entry_host_ms`` (layer: entry and dispatch): the median host time of
one call of the entry point, from entering it to its return, over the
measured window's calls (the benchmark's own span around each call, on
the host clock; the traced window's calls carry the profiler's cost and
are not read)."""

import statistics

UNIT = "ms"


def read(ctx: dict):
    host = ctx["entry_host_s"]
    return statistics.median(host) * 1e3 if host else None
