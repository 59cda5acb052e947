"""End-to-end reference workloads as runnable library functions."""
from .simjeb import run_simjeb_workload, synthesize_simjeb_bundle  # noqa: F401
