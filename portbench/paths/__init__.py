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
  float64 numpy in node order, or None where set-up derives none over
  all nodes (nothing is then compared);
* ``apply_call()`` returns a callable that applies the operator once, for
  the apply timing of a traced run;
* ``close()`` drops the program's state;
* ``element_weights()`` (optional) returns the per-element weight tensors
  of operators the path keeps by element after its build that the CPU
  tests' halved-batch fault would not otherwise find (it finds
  ``system.op.W``, the refined system's float64 chunks and a static
  model's element matrices): the fault halves them in place.  The fault
  is planted after the build, so on a path that condenses the system it
  reaches only these (a matrix-free interface operator), not the blocks
  that the build condensed from the element matrices; such a path's own
  CPU test plants the halving in the program's element matrices before
  the build as well, as ``test_a_condensing_path_needs_files_only`` does.

A module also names ``OPERATOR``, the operator whose apply its roofline
metric times: any name that has a metric ``<OPERATOR>_apply_roofline``
(``packed`` and ``assembled`` today), ``DTYPE`` (its working
precision, "float32" or "float64"), and ``DIAG_LIMIT``, the largest
relative difference of the diagonal from the reference's that counts as
correct (None: printed, not compared).

One more constant says what the CPU tests (portbench/tests) may expect of
the path; they read it with this default, so a module states it only
where it differs:

* ``FROZEN_ZERO`` (default True): the path's answer is exactly 0 when its
  Krylov state never moves, as it is where the Krylov solve from x0 = 0
  is the whole solve; a frozen state then reads ``resid_max`` 1 exactly.
  A path that condenses the system solves each part's interior directly
  (u_I = K_II^-1 f_I with the interface at 0) whatever its Krylov state
  does, and states False: a frozen state must then fail every solve and
  read ``resid_max`` at least 1e-2, 10,000 times the traffic's 1e-6 bar.

The CPU tests run a path's control at box (3, 3, 3), where it must read
more than 3 times the bar.  A cell whose float32 round-off shows only on
a larger mesh (a substructured solve's grows about as n^2) sets that mesh
in its configuration's ``cpu_test`` entry, which replaces the mesh of
every CPU run of the cell.  It may: the control is a test of the
comparison that decides ``correct``, and on the chip it runs at the
cell's own size; the margin of 3 times the bar holds for every path.
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
