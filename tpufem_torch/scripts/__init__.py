"""Command-line flows of tpufem_torch (run with ``python -m``)."""
