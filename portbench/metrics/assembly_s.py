"""Seconds of ``build_static_model`` (element stiffness by kernel
stiffness_fused, the cluster plan, the clustered operator): the harness's
synchronised span around it."""


def read(ctx):
    return ctx.stages.get("assembly")
