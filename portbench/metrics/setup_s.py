"""Set-up seconds: from the harness's start (before torch is imported) to
the window's start: imports, the card's context, the mesh and the loads,
the system's build stages, graph capture, kernel load and one untimed
solve."""


def read(ctx):
    return ctx.setup_s
