"""The paths that a cell's window drives, one module each.

A path module has a ``Path`` class built by the harness as
``Path(mesh, config, traffic, device, stages, control)``:

* ``__init__`` builds the system from the benchmark's arrays (``mesh``:
  coords, conn, the fixed nodes) and the configuration (its material, and
  its ``element`` type, which it hands to the program as the mesh's
  element), each stage inside ``stages("<name>")``,
  which synchronises the device and records the seconds; ``control=True``
  builds the program's own path one precision below the configuration's
  (the control of the correctness check, never run by a timed run);
* ``solve(b)`` solves one load case [N, 3] from a cold start to the
  traffic's accuracy and returns ``(u [N, 3] float64 numpy, converged,
  iterations, detail)``;
* ``warm(b)`` runs ``solve``'s code once, capped after a block or two of
  iterations, so that every kernel, graph and buffer of the window exists
  before it opens (set-up: a whole solve would only add its seconds);
* ``diagonal()`` returns the Jacobi diagonal that set-up derived, [N, 3]
  float64 numpy in node order;
* ``apply_call()`` returns a callable that applies the operator once, for
  the apply timing of a traced run;
* ``close()`` drops the program's state.

A module also names ``OPERATOR``, the operator whose apply its roofline
metric times: any name that has a metric ``<OPERATOR>_apply_roofline``
(``packed`` and ``assembled`` today), ``DTYPE`` (its working
precision, "float32" or "float64"), and ``DIAG_LIMIT``, the largest
relative difference of the diagonal from the reference's that counts as
correct (None: printed, not compared).
"""


def packed_diagonal(system):
    """A PackedSystem's Jacobi diagonal, [N, 3] float64 numpy."""
    op = system.op
    return op.plan.unpack(op.diagonal()).double().cpu().numpy()


def packed_apply_call(system):
    """One apply of a PackedSystem's operator on a fixed packed field."""
    import torch
    op = system.op
    g = torch.Generator(device=op.W.device).manual_seed(0)
    X = torch.randn((op.plan.meta.n_blocks, 384), generator=g,
                    dtype=op.W.dtype, device=op.W.device)
    return lambda: op(X)
