"""``roofline.sg1d_mirror`` (layer: kernels): a scipy ``mode="mirror"``
call's function bound (``roofline.sg1d``: each byte once, 2 operations a
tap a sample, whatever pads the rows) over the device time of all of the
call's operations, whichever they are (pad, kernel, multiply), in the
cells whose configuration runs the ``sg1d_mirror`` function."""

from gpubench import trace

UNIT = "%"


def read(ctx: dict):
    return trace.roofline_share(ctx, "sg1d_mirror")
