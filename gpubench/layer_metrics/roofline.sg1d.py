"""``roofline.sg1d`` (layer: kernels): a 1D call's function bound
(``roofline.sg1d``: each byte once, 2 operations a tap a sample) over the
device time of all of the call's operations, whichever kernels they are,
in the cells whose configuration runs the ``sg1d`` function."""

from gpubench import trace

UNIT = "%"


def read(ctx: dict):
    return trace.roofline_share(ctx, "sg1d")
