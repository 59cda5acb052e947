"""PCG iterations per load case: the iterations that the path reports
(inner iterations of the refined solve) summed over the window's solves,
over the solves."""


def read(ctx):
    if not ctx.solves:
        return None
    return sum(s["iterations"] for s in ctx.solves) / len(ctx.solves)
