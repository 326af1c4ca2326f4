"""``roofline.sg1d_bf16`` (layer: kernels): a bf16-storage 1D call's
function bound (``roofline.sg1d`` at 2 B a sample: each byte once, 2
operations a tap a sample) over the device time of all of the call's
operations, whichever they are (the taps' casts, the kernel), in the cells
whose configuration runs the ``sg1d_bf16`` function."""

from gpubench import trace

UNIT = "%"


def read(ctx: dict):
    return trace.roofline_share(ctx, "sg1d_bf16")
