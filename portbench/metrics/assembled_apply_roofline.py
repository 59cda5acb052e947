"""The assembled operator's apply against the least time the card could
take for it, in percent.

The time is read as for packed_apply_roofline (the device time inside
the ``portbench.apply`` spans, over the calls).  The least time is counted
from the configuration: each element matrix's upper triangle, the least a
symmetric store holds ((3k)(3k + 1) / 2 values), read once, with X read
once and Y written once (3 values a node each); operations: the element
matrix-vector product's (3k)^2 multiply-adds, two operations each.  The
bound is the larger of bytes over the HBM bandwidth and operations over
the peak rate of the working precision.
"""
from .. import peaks


def count(elements: int, nodes: int, k: int, itemsize: int):
    """(bytes, operations) of one apply."""
    d = 3 * k
    nbytes = elements * d * (d + 1) // 2 * itemsize + 2 * 3 * nodes * itemsize
    flops = 2 * elements * d * d
    return nbytes, flops


def read(ctx):
    if ctx.apply_s is None or ctx.operator != "assembled":
        return None
    c = ctx.config
    nbytes, flops = count(c["elements"], c["nodes"], c["element"]["nodes"],
                          peaks.ITEMSIZE[ctx.dtype])
    return 100.0 * peaks.bound_seconds(nbytes, flops, ctx.dtype) / ctx.apply_s
