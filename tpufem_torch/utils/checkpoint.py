"""Checkpoint / resume for long solves, in numpy's npz format.

The port of tpufem/utils/checkpoint.py.  The reference's only resume
mechanism is the ``u_init`` warm-start argument on every solver
(solver/solver.py:11,144,...).  That API is preserved throughout the port;
this module adds durable state so a long CG / Newton / modal run survives
preemption:

    save_state(path, {"u": u, "iteration": i, ...})
    state = load_state(path)
    cg(..., x0=state["u"])

tpufem saves through orbax when it can and falls back to npz; orbax is a
JAX library, so the port writes and reads npz only (tpufem's fallback
format: ``path`` or ``path + ".npz"``).
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def save_state(path: str, state: Dict[str, Any]) -> None:
    """Save a flat dict of arrays or tensors (tensors are copied to host
    numpy) as `path`.npz."""
    np.savez(_npz(path), **{k: _to_numpy(v) for k, v in state.items()})


def load_state(path: str) -> Optional[Dict[str, np.ndarray]]:
    """Load a previously saved state as numpy arrays; None if absent."""
    npz = _npz(path)
    if not os.path.exists(npz):
        return None
    with np.load(npz, allow_pickle=False) as f:
        return {k: f[k] for k in f.files}


def checkpointed_cg(A, b: torch.Tensor, path: str, *, every: int = 200,
                    total_iter: int = 2000, **cg_kw):
    """CG in restartable chunks of `every` iterations, saving u after each.

    Resumes automatically from an existing checkpoint at `path`.  As in
    tpufem, each chunk is a fresh `cg` call started at the saved u (a
    restart, not cg's exact `resume_state` continuation), and the
    iteration count is summed over the chunks and calls.  Returns (u,
    SolveInfo of the last chunk, iterations done in all)."""
    from ..solvers.cg import CONVERGED, cg

    state = load_state(path)
    u = (torch.as_tensor(state["u"]).to(b.device, b.dtype)
         if state is not None else None)
    done = int(state["iterations"]) if state is not None else 0
    info = None
    while done < total_iter:
        u, info = cg(A, b, x0=u, max_iter=min(every, total_iter - done),
                     **cg_kw)
        done += int(info.iterations)
        save_state(path, {"u": u, "iterations": np.asarray(done)})
        if int(info.status) == CONVERGED:
            break
    return u, info, done
