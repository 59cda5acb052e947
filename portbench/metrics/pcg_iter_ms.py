"""Milliseconds per PCG iteration: the traced window's whole length (one
whole solve, its host work included) over the iterations it held."""


def read(ctx):
    if ctx.trace is None or not ctx.traced_iterations:
        return None
    return ctx.trace.window_s * 1e3 / ctx.traced_iterations
