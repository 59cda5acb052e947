"""SimJEB-style HDF5 sample loader (a copy of tpufem/io/h5.py; h5py and
yaml are imported when a function needs them).

Parity with the reference workload ingestion (solver_example.ipynb cell 3):
datasets 'forces', 'rbe2', 'rbe3', 'outputs' per sample, plus the YAML
boundary files of subdivision.ipynb cell 3 ({'rbe2': [{'slaves': ...}],
'rbe3': [...]}).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def load_simjeb_sample(path: str) -> Dict[str, np.ndarray]:
    """Load one SimJEB h5 sample into numpy arrays."""
    import h5py

    out = {}
    with h5py.File(path, "r") as f:
        for key in ("forces", "rbe2", "rbe3", "outputs"):
            if key in f:
                out[key] = np.asarray(f[key][...])
    return out


def load_boundary_yaml(path: str) -> Dict[str, np.ndarray]:
    """{'rbe2': slave ids, 'rbe3': slave ids} from a boundary YAML file."""
    import yaml

    with open(path) as f:
        boundary = yaml.safe_load(f)
    out = {}
    for key in ("rbe2", "rbe3"):
        if key in boundary:
            out[key] = np.concatenate(
                [np.asarray(c["slaves"]) for c in boundary[key]])
    return out


def rbe2_mask(n_nodes: int, rbe2_ids) -> np.ndarray:
    """0/1 int mask over nodes (solver_example.ipynb cell 3)."""
    m = np.zeros(n_nodes, dtype=np.int32)
    m[np.asarray(rbe2_ids)] = 1
    return m
