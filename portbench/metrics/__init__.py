"""One module per metric, found by the metric's name in BENCHMARK.json.

Each has ``read(ctx)``, which returns the metric's value from the run's
context (``portbench.harness.Context``) or None where the run has nothing
to read it from (the harness then leaves the metric out of the result).
A roofline metric keeps the function that counts its operation's bytes
and operations beside its reader.
"""
