"""Mesh and sample file I/O: VTK (.vtk, .vtu) and SimJEB h5 samples."""
