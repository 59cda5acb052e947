"""The packed operator's apply against the least time the card could take
for it, in percent.

The time is the device time of every operation launched inside the
benchmark's ``portbench.apply`` spans around calls of the operator (one
apply each, eager, whatever kernels those are), over the calls.  The
least time is counted from the configuration, never from the program's
tables, so that no change of plan, fusion or kernels makes it stale:

* bytes: the displacement X read once and the forces Y written once
  (3 values a node each), the coordinates read once (3 values a node, in
  the working precision) and the connectivity read once (int32): the
  least any matrix-free implementation must move;
* operations: the element action's multiply-adds, two operations each.
  At each quadrature point, given J^-1 and W: the reference gradient
  dN^T u_e (9k), H = J^-T of it (27), sigma = lam tr(H) I + mu (H + H^T)
  (12), T = W J^-1 sigma (36), and the element forces dN T (9k): 18k + 75.

The bound is the larger of bytes over the HBM bandwidth and operations
over the peak rate of the working precision (portbench.peaks).
"""
from .. import peaks


def count(elements: int, nodes: int, k: int, q: int, itemsize: int):
    """(bytes, operations) of one apply."""
    nbytes = 3 * 3 * nodes * itemsize + elements * k * 4
    flops = 2 * elements * q * (18 * k + 75)
    return nbytes, flops


def read(ctx):
    if ctx.apply_s is None or ctx.operator != "packed":
        return None
    c = ctx.config
    nbytes, flops = count(c["elements"], c["nodes"], c["element"]["nodes"],
                          c["element"]["points"], peaks.ITEMSIZE[ctx.dtype])
    return 100.0 * peaks.bound_seconds(nbytes, flops, ctx.dtype) / ctx.apply_s
