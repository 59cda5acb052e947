"""The reference's elements, one module each, found by the ``type`` of a
configuration's ``element`` entry (``portbench/reference/elements/<type>.py``).

An element module gives ``POINTS`` [q, 3] (the quadrature points in the
reference element's coordinates (xi, eta, zeta)), ``WEIGHTS`` [q] and
``gradients(points) -> [q, k, 3]``, the derivatives of its k shape
functions in (xi, eta, zeta) at the points.  Each is written from the
equations with numpy alone: nothing of the program.
"""
import importlib


def load(etype: str):
    """The module ``portbench.reference.elements.<etype>``."""
    return importlib.import_module(__name__ + "." + etype)
