"""The four distributed systems on a GroupMesh (torch.distributed, two
gloo ranks on the CPU) bitwise against the same systems on PartMesh(2).

One spawn of two processes on a FileStore in tmp_path: each rank builds
DistFEM, HaloFEM, HaloPartialFEM and PackedHaloFEM at P = 2 and runs one
spmv and a 20-iteration pcg of each; every gathered result is bitwise the
PartMesh(2) run of this process.  The join has its own 60 s timeout, so a
hang fails the test instead of eating the run's clock.  The ranks import
this module (it imports neither jax nor tpufem).
"""
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

E, NU = 200e9, 0.3
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
JOIN_TIMEOUT = 60


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One torch thread while this module runs (the ranks use one too, so
    every reduction runs the same code in both backends)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run_all(mesh):
    """{name: tensor} of the four systems on `mesh` (gathered to the
    global rows)."""
    from tpufem_torch.parallel import dist, halo, halo_partial, packed_dist
    from tpufem_torch.utils import meshgen

    out = {}

    def record(name, fem, u, b):
        out[name + "_spmv"] = fem.gather(fem.spmv(u))
        x, info = fem.pcg(b, tol=0.0, max_iter=20)
        out[name + "_pcg"] = fem.gather(x)
        out[name + "_history"] = info.history
        out[name + "_iterations"] = info.iterations

    def load(coords, z_top):
        N = coords.shape[0]
        rng = np.random.default_rng(0)
        b = np.zeros((N, 3))
        b[meshgen.boundary_nodes(coords, 2, z_top), 0] = 1e3
        return (meshgen.boundary_nodes(coords, 2, 0.0),
                torch.as_tensor(rng.standard_normal((N, 3))),
                torch.as_tensor(b))

    coords, conn = meshgen.box_tet(3, 3, 3)
    fixed, u, b = load(coords, 1.0)
    for name, build in (("dist", dist.build_distributed_fem),
                        ("halo", halo.build_halo_fem)):
        fem, part = build(coords, conn, "c3d4", E, NU, mesh=mesh,
                          fixed_nodes=fixed)
        record(name, fem, part.to_new(u), part.to_new(b))
    coords, conn = meshgen.box_tet10(3, 3, 4)
    fixed, u, b = load(coords, 1.0)
    fem, part = halo_partial.build_halo_partial_fem(
        coords, conn, "c3d10", E, NU, mesh=mesh, fixed_nodes=fixed)
    record("halo_partial", fem, part.to_new(u), part.to_new(b))
    coords, conn = meshgen.box_tet10(3, 3, 6, 1.0, 1.0, 2.0)
    fixed, u, b = load(coords, 2.0)
    fem, part = packed_dist.build_packed_halo_fem(
        coords, conn, "c3d10", E, NU, mesh=mesh, fixed_nodes=fixed,
        elems_per_cluster=8, precondition="block", dtype=torch.float64)
    assert part.meta.x_rounds and part.meta.c_rounds
    record("packed", fem, part.pack_np(u.numpy()), part.pack_np(b.numpy()))
    return out


def _rank_main(rank: int, store: str, result: str) -> None:
    """One gloo rank: run_all on a GroupMesh, results saved to
    result.<rank>."""
    import torch.distributed as tdist

    from tpufem_torch.parallel.dist import GroupMesh

    torch.set_num_threads(1)
    tdist.init_process_group("gloo", store=tdist.FileStore(store, 2),
                             rank=rank, world_size=2)
    try:
        mesh = GroupMesh(device="cpu")
        assert mesh.n_parts == 2 and mesh.local_parts == (rank,)
        torch.save(run_all(mesh), f"{result}.{rank}")
    finally:
        tdist.destroy_process_group()


def test_group_mesh_bitwise_part_mesh(tmp_path):
    from tpufem_torch.parallel.dist import PartMesh

    store, result = str(tmp_path / "store"), str(tmp_path / "result")
    code = ("import sys; sys.path[:0] = [%r, %r]; "
            "import test_torch_dist_group as t; "
            "t._rank_main(int(sys.argv[1]), %r, %r)"
            % (ROOT, HERE, store, result))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)],
                              cwd=str(tmp_path), env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = []
    try:
        for p in procs:
            left = max(1.0, JOIN_TIMEOUT - (time.perf_counter() - t0))
            logs.append(p.communicate(timeout=left)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"the gloo ranks did not finish in {JOIN_TIMEOUT} s")
    assert [p.returncode for p in procs] == [0, 0], "\n".join(logs)

    ref = run_all(PartMesh(2, device="cpu"))
    for rank in range(2):
        got = torch.load(f"{result}.{rank}")
        assert set(got) == set(ref)
        for key in ref:
            assert torch.equal(got[key], ref[key]), (rank, key)
    for name in ("dist", "halo", "halo_partial", "packed"):
        assert int(ref[name + "_iterations"]) == 20
