"""Seconds of ``PackedPlan.build`` (host numpy and the native engine, the
tables moved to the card): the harness's synchronised span around it."""


def read(ctx):
    return ctx.stages.get("plan")
