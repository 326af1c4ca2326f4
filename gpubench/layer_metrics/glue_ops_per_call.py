"""``glue_ops_per_call`` (layer: entry and dispatch): the card's
operations a call launches inside the program's ``savgol.apply`` span but
in no ``savgol.launch`` span, by the launch's correlation id: the glue a
call launches beside its kernels (``spans.glue_ops_per_call``). 0 is a
reading; nothing is read where the trace holds no ``savgol.apply``."""

from gpubench import spans

UNIT = "ops"


def read(ctx: dict):
    return spans.glue_ops_per_call(ctx)
