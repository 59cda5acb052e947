"""Host reads of the device per load case: the program's counter
``host_syncs`` (each status, count or history read that waits for the
card) over the traced solve, from the program's recording of that solve
(``Context.recording``, --trace 1 only).  A recording holds the counters
that changed, so a solve that read nothing reads 0."""


def read(ctx):
    if ctx.recording is None:
        return None
    return ctx.recording.counts.get("host_syncs", 0)
