"""The benchmark's mesh generators, one module each, found by the
``generator`` of a configuration's ``mesh`` entry
(``portbench/meshes/<generator>.py``).

A generator module gives

* ``make(n, size) -> (coords [N, 3] float64, conn [M, k] int32)``: the
  mesh of the counts ``n`` (cells along each axis) and the box's ``size``;
* ``sizes(n) -> (elements, nodes)``: the same counts worked out from ``n``
  alone, so that a test can shrink a cell without building its mesh.

Host numpy only, copied from the program's generators so that a later
change to the program cannot move the benchmark's inputs: nothing here
imports torch or the program.
"""
