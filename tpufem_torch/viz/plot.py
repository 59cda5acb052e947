"""Plotly mesh/field visualizers (optional dependency, gracefully gated).

Capability parity with the reference viewers (solver/element.py:93-275,
2716-3341): mesh surface render with boundary-face extraction, node scalar
scatter, target-node highlight, surface normals, shared-face force views.
plotly is optional: without it every function raises a clear
ImportError, and works when plotly is available.  Figures are returned
(not .show()n) so they can be saved headlessly; `show=True` displays.

The port of tpufem/viz/plot.py: the same figures, with torch tensors (on
any device) taken to host numpy first.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..topology import faces as topo_faces


def _require_plotly():
    try:
        import plotly.graph_objects as go
        return go
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "plotly is required for tpufem_torch.viz (pip install plotly)"
        ) from e


def _as_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _boundary_triangles(coords, elements, element_type):
    et = element_type.lower()
    if et == "s3":
        return _as_np(elements)
    if et == "s4":
        q = _as_np(elements)
        return np.concatenate([q[:, [0, 1, 2]], q[:, [0, 2, 3]]], axis=0)
    tris = []
    for kind, (f, _) in topo_faces.boundary_faces(_as_np(elements), et).items():
        if kind == "tri":
            tris.append(f)
        else:
            tris.append(f[:, [0, 1, 2]])
            tris.append(f[:, [0, 2, 3]])
    return np.concatenate(tris, axis=0)


def visualize_mesh(coords, elements, element_type, title="Mesh Visualization",
                   show: bool = False, **mesh_kw):
    """Boundary-surface render (reference visualize_mesh, element.py:93)."""
    go = _require_plotly()
    coords = _as_np(coords)
    tris = _boundary_triangles(coords, elements, element_type)
    fig = go.Figure(data=[go.Mesh3d(
        x=coords[:, 0], y=coords[:, 1], z=coords[:, 2],
        i=tris[:, 0], j=tris[:, 1], k=tris[:, 2],
        opacity=mesh_kw.pop("opacity", 0.5),
        color=mesh_kw.pop("color", "lightgrey"), flatshading=True, **mesh_kw)])
    fig.update_layout(title=title, scene=dict(aspectmode="data"))
    if show:
        fig.show()
    return fig


def visualize_node_with_value(coords, value, size=2.0, colorscale="Viridis",
                              title="Node-wise Von Mises Stress",
                              bar_title="Von Mises Stress", show=False):
    """Scalar-per-node scatter (reference element.py:195)."""
    go = _require_plotly()
    coords, value = _as_np(coords), _as_np(value)
    fig = go.Figure(data=go.Scatter3d(
        x=coords[:, 0], y=coords[:, 1], z=coords[:, 2], mode="markers",
        marker=dict(size=size, color=value, colorscale=colorscale,
                    colorbar=dict(title=bar_title), opacity=0.8),
        text=[f"Node {i}<br>Value: {v:.4g}" for i, v in enumerate(value)],
        hoverinfo="text"))
    fig.update_layout(title=title, scene=dict(aspectmode="data"))
    if show:
        fig.show()
    return fig


def visualize_target_nodes(coords, node_ids=None, marker_size=2.0,
                           target_marker_size=6.0, show=False):
    """Highlight nodes in red (reference element.py:242)."""
    go = _require_plotly()
    coords = _as_np(coords)
    N = coords.shape[0]
    colors = np.array(["blue"] * N, dtype=object)
    sizes = np.full(N, marker_size)
    if node_ids is not None:
        colors[_as_np(node_ids)] = "red"
        sizes[_as_np(node_ids)] = target_marker_size
    fig = go.Figure(data=go.Scatter3d(
        x=coords[:, 0], y=coords[:, 1], z=coords[:, 2], mode="markers",
        marker=dict(size=sizes, color=list(colors))))
    fig.update_layout(title="3D Node Visualization",
                      scene=dict(aspectmode="data"))
    if show:
        fig.show()
    return fig


def visualize_surface_with_red_nodes(coords, elements, node_ids=None,
                                     element_type="c3d4", show=False):
    """Boundary surface + highlighted nodes (reference element.py:2716)."""
    go = _require_plotly()
    fig = visualize_mesh(coords, elements, element_type)
    coords = _as_np(coords)
    if node_ids is not None:
        sel = coords[_as_np(node_ids)]
        fig.add_trace(go.Scatter3d(
            x=sel[:, 0], y=sel[:, 1], z=sel[:, 2], mode="markers",
            marker=dict(size=4, color="red")))
    if show:
        fig.show()
    return fig


def visualize_surface_with_normals(coords, elements, element_type="c3d4",
                                   scale: float = 0.1, show=False):
    """Boundary faces + outward normal cones (reference element.py:2754)."""
    go = _require_plotly()
    coords = _as_np(coords)
    fig = visualize_mesh(coords, elements, element_type)
    for kind, (f, n) in topo_faces.outward_surface_normals(
            coords, _as_np(elements), element_type).items():
        centers = coords[f].mean(axis=1)
        fig.add_trace(go.Cone(
            x=centers[:, 0], y=centers[:, 1], z=centers[:, 2],
            u=n[:, 0] * scale, v=n[:, 1] * scale, w=n[:, 2] * scale,
            sizemode="absolute", sizeref=scale, showscale=False))
    if show:
        fig.show()
    return fig


def visualize_shared_face_forces(coords, elements, element_type,
                                 face_forces, show=False):
    """Interior-face residual force magnitudes (reference element.py:2834)."""
    go = _require_plotly()
    from ..topology.diagnostics import shared_face_force_residual

    coords = _as_np(coords)
    res = shared_face_force_residual(_as_np(elements), element_type,
                                     _as_np(face_forces))
    sf = topo_faces.shared_faces(_as_np(elements), element_type)
    # face centers of the first member of each pair
    fam_tables = {"c3d4": topo_faces.TET_FACES}
    table = fam_tables.get(element_type.lower(), topo_faces.TET_FACES)
    f_nodes = _as_np(elements)[sf[:, 0, 0][:, None],
                               table[sf[:, 0, 1]]]
    centers = coords[f_nodes].mean(axis=1)
    mag = np.linalg.norm(res, axis=1)
    fig = go.Figure(data=go.Scatter3d(
        x=centers[:, 0], y=centers[:, 1], z=centers[:, 2], mode="markers",
        marker=dict(size=3, color=mag, colorscale="Hot",
                    colorbar=dict(title="|force residual|"))))
    fig.update_layout(title="Shared-face force residuals",
                      scene=dict(aspectmode="data"))
    if show:
        fig.show()
    return fig


# Reference-name aliases (element.py:2834 visualize_shared_face_with_forces,
# element.py:3066 ..._and_norm — both render interior-face force residuals;
# the magnitude coloring covers the "_and_norm" variant).
visualize_shared_face_with_forces = visualize_shared_face_forces
visualize_shared_face_with_forces_and_norm = visualize_shared_face_forces
