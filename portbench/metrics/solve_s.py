"""Seconds per converged load case: the window's whole time over the
cases it solved (a case the path reports unconverged is not solved)."""


def read(ctx):
    solved = sum(1 for s in ctx.solves if s["converged"])
    return ctx.window_s / solved if solved else None
