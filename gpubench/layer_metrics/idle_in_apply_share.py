"""``idle_in_apply_share`` (layer: entry and dispatch): the share of the
traced window taken by the stretches with no operation on the card that
began while the host was inside the program's ``savgol.apply`` span: the
idle time the program's own host work holds the card for, a part of
``device_idle_share`` (``spans.idle_in_apply_share``)."""

from gpubench import spans

UNIT = "%"


def read(ctx: dict):
    return spans.idle_in_apply_share(ctx)
