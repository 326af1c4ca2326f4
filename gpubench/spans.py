"""The program's own spans in the traced window, read call by call.

The port records three host spans while a ``torch.profiler`` session is
recording (``savgol_tpu_torch/tracing.py``): ``savgol.apply``, the body of
a public entry point; ``savgol.taps``, a call's preparation of its taps;
``savgol.launch``, the foreign call that enqueues one kernel. They lie in
the same trace as the benchmark's ``enqueue`` spans and the card's
operations, on one clock. A call is an ``enqueue`` span; its program spans
are the ``savgol.apply`` spans that start in it (the outermost ones: the
complex-input route nests a second), and the ``savgol.taps`` and
``savgol.launch`` spans inside those. Where the trace holds no
``savgol.apply`` (a program that records no spans) every function here
gives None.
"""

from __future__ import annotations

import bisect
import statistics

from gpubench import trace

APPLY, TAPS, LAUNCH = "savgol.apply", "savgol.taps", "savgol.launch"


def union(spans: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """The union of ``spans`` as sorted, disjoint ``(start, end)``: nested
    spans of one name give their outermost."""
    merged: list[list[float]] = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _covered(spans: list[tuple[float, float]], a: float, b: float) -> float:
    """How much of ``[a, b]`` the sorted, disjoint ``spans`` cover."""
    return sum(max(0.0, min(e, b) - max(s, a)) for s, e in spans)


def applies_by_call(ctx: dict) -> list[list[tuple[float, float]]] | None:
    """For each call of the traced window, the outermost ``savgol.apply``
    spans that start in it; None where the trace holds none at all."""
    applies = union(trace.spans(ctx["events"], APPLY))
    if not applies or not ctx["calls"]:
        return None
    starts = [c[0] for c in ctx["calls"]]
    out: list[list] = [[] for _ in ctx["calls"]]
    for a, b in applies:
        i = bisect.bisect_right(starts, a) - 1
        if i >= 0 and a < ctx["calls"][i][1]:
            out[i].append((a, b))
    return out


def host_split(ctx: dict) -> list[dict] | None:
    """For each call holding a ``savgol.apply``, its host time in us:
    ``apply`` (the outermost spans' durations), ``taps`` and ``launch``
    (the time their spans cover inside them) and ``self`` (``apply`` less
    the union of the two: routing, checks, the ``autograd.Function``,
    output allocation); None where there is no such call."""
    by_call = applies_by_call(ctx)
    if by_call is None:
        return None
    taps = union(trace.spans(ctx["events"], TAPS))
    launches = union(trace.spans(ctx["events"], LAUNCH))
    children = union(taps + launches)
    out = []
    for applies in by_call:
        if applies:
            out.append({
                "apply": sum(b - a for a, b in applies),
                "taps": sum(_covered(taps, a, b) for a, b in applies),
                "launch": sum(_covered(launches, a, b) for a, b in applies),
                "self": sum(b - a - _covered(children, a, b)
                            for a, b in applies)})
    return out or None


def median_ms(ctx: dict, part: str) -> float | None:
    """The median over calls of ``host_split``'s ``part``, in ms."""
    split = host_split(ctx)
    return None if split is None else statistics.median(
        c[part] for c in split) * 1e-3


def glue_ops_per_call(ctx: dict) -> float | None:
    """The device operations a call launches inside its ``savgol.apply``
    but in no ``savgol.launch`` (matched by the launch's correlation id,
    as ``trace.launched_in``), over the calls holding a ``savgol.apply``;
    None where there is none."""
    by_call = applies_by_call(ctx)
    if by_call is None:
        return None
    calls = [a for a in by_call if a]
    if not calls:
        return None
    applies = [s for a in calls for s in a]
    in_apply = [e for group in trace.launched_in(ctx["events"], applies)
                for e in group]
    launches = union(trace.spans(ctx["events"], LAUNCH))
    kernels = {id(e) for group in trace.launched_in(ctx["events"], launches)
               for e in group}
    return sum(id(e) not in kernels for e in in_apply) / len(calls)


def idle_in_apply_share(ctx: dict) -> float | None:
    """The share of the traced window, in %, taken by the stretches in
    which the card ran none of the window's operations and that began
    while the host was inside a ``savgol.apply`` (``trace.idle_gaps``'
    rule); None where there is no ``savgol.apply`` or no operation."""
    if ctx["window"] is None:
        return None
    applies = union(trace.spans(ctx["events"], APPLY))
    t0, t1 = ctx["window"]
    ops = trace.launched_in(ctx["events"], [(t0, t1)])[0]
    if not applies or not ops:
        return None
    gaps = trace.idle_gaps(ops, t0, t1, {APPLY: applies})
    return 100.0 * sum(us for label, us in gaps if label == APPLY) / (t1 - t0)
