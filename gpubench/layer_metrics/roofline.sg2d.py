"""``roofline.sg2d`` (layer: kernels): a 2D call's function bound
(``roofline.sg2d``: each byte once, the stencil at its separable rank)
over the device time of all of the call's operations, whichever kernels
they are, in the cells whose configuration runs the ``sg2d`` function."""

from gpubench import trace

UNIT = "%"


def read(ctx: dict):
    return trace.roofline_share(ctx, "sg2d")
