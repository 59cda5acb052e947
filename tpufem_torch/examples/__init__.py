"""Examples of tpufem_torch (run with ``python -m``)."""
