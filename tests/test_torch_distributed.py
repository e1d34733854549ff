"""The port's multi-process runtime (`parallel/distributed.py`,
`parallel/mesh.py`) and what drives it: `entry.dryrun_multichip`,
`tools/scaling_bench.py`, and `kernels.build` run by several processes at
once.

The counterpart of tests/test_distributed.py: two OS processes join one
world through `init_runtime` over tcp:// (one from arguments, one from
torch's own environment variables, as `torchrun` sets them) and run the
edge-sharded essential graph; each checks the result against its own
single-process solve within 1e-4, as the JAX test does. Worlds are gloo on
the CPU here; the card-only cases (a NCCL world of one rank, two gloo ranks
sharing `cuda:0`) carry the `gpu` marker.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch_port_fixtures import (cuda_device, mesh_2d_rank, rank_that_fails,  # noqa: F401
                                 run_ranks, sharding_mesh_problem, sharding_rank)

from orbslam2_nmi_torch import entry as tentry
from orbslam2_nmi_torch.parallel import distributed
from orbslam2_nmi_torch.tools import scaling_bench

ROOT = Path(__file__).resolve().parent.parent
# one mesh grid: its binning (bin_count, bin_fill), B1, B2 and render_gray once
# each; B3's keys epilogue and the point splat's kernels are not on the path
MESH_GRID_LAUNCHES = {"joint_entropy": 1, "marginal_entropy": 1, "rasterize_keys": 0,
                      "render_gray": 1, "bin_count": 1, "bin_fill": 1, "splat_scatter": 0,
                      "splat_resolve": 0}

_WORKER = r"""
import os, sys
import numpy as np, torch
torch.set_num_threads(1)
pid, port = int(sys.argv[1]), sys.argv[2]
from orbslam2_nmi_torch.parallel import distributed, sharded_pose_graph
from orbslam2_nmi_torch.geometry import se3
from orbslam2_nmi_torch.solvers import pose_graph
if pid == 0:
    dev = distributed.init_runtime(f"tcp://127.0.0.1:{port}", 2, 0, device="cpu")
else:  # torch's own environment, as torchrun sets it
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=port, WORLD_SIZE="2", RANK="1")
    dev = distributed.init_runtime(device="cpu")
import torch.distributed as dist
assert dist.get_world_size() == 2 and dist.get_rank() == pid and dev.type == "cpu"
V = 10
xi = lambda *v: se3.se3_exp(torch.tensor(v, dtype=torch.float32)).numpy()
gt = [xi(0.5 * i, 0, 0, 0, 0, 0) for i in range(V)]
est = [gt[0]]
for i in range(1, V):
    est.append(xi(0.02, 0.01, 0, 0, 0.004, 0) @ (gt[i] @ np.linalg.inv(gt[i - 1])) @ est[i - 1])
est = np.stack(est)
ei = list(range(V - 1)) + [0]
ej = list(range(1, V)) + [V - 1]
meas = [est[j] @ np.linalg.inv(est[i]) for i, j in zip(ei[:-1], ej[:-1])]
meas.append(gt[V - 1] @ np.linalg.inv(gt[0]))
t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
prob = pose_graph.PoseGraphProblem(
    Scw=t(est.astype(np.float32)), fixed=t(np.arange(V) == 0), valid=t(np.ones(V, bool)),
    edge_i=t(np.asarray(ei, np.int32)), edge_j=t(np.asarray(ej, np.int32)),
    edge_Sji=t(np.stack(meas).astype(np.float32)), edge_valid=t(np.ones(V, bool)))
mesh = distributed.global_mesh()
assert mesh.size() == 2
out = sharded_pose_graph.sharded_optimize_pose_graph(mesh, prob, iters=10).numpy()
single = pose_graph.optimize_pose_graph(prob, iters=10).numpy()
np.testing.assert_allclose(out, single, atol=1e-4)
# every rank holds rank 0's value after replicate
assert float(distributed.replicate(torch.tensor([float(pid)]))[0]) == 0.0
distributed.shutdown()
print(f"proc {pid}: distributed pose graph ok over 2 processes")
"""


def test_two_process_world_pose_graph(tmp_path):
    port = distributed.free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                        "LOCAL_WORLD_SIZE")}
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    procs = [subprocess.Popen([sys.executable, str(worker), str(i), str(port)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, cwd=ROOT)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0].decode())
    finally:
        for p in procs:
            p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out}"
        assert "distributed pose graph ok over 2 processes" in out, out


@pytest.mark.parametrize("given", [dict(coordinator_address="127.0.0.1:1"),
                                   dict(num_processes=2), dict(process_id=0),
                                   dict(num_processes=2, process_id=0)])
def test_init_runtime_rejects_a_partial_configuration(monkeypatch, given):
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match="incomplete torch.distributed configuration"):
        distributed.init_runtime(device="cpu", **given)


def test_nccl_takes_one_card_a_rank(monkeypatch):
    """A NCCL world larger than the visible cards raises before it starts;
    NCCL refuses a CPU device; CUDA asked for without a card raises."""
    with pytest.raises(ValueError, match="NCCL carries CUDA tensors only"):
        distributed.init_runtime("127.0.0.1:1", 1, 0, backend="nccl", device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        distributed.init_runtime("127.0.0.1:1", 1, 0, device="cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    with pytest.raises(RuntimeError, match="2 ranks on this host, 1 visible cards"):
        distributed.init_runtime("127.0.0.1:1", 2, 0, device="cuda")


def test_failed_rank_ends_the_world():
    """A rank that raises ends the world: the call raises with its
    traceback and the ranks waiting for it are stopped."""
    with pytest.raises(RuntimeError, match="rank 1 of 3 failed") as e:
        run_ranks(rank_that_fails, 3, 1)
    assert "fails on purpose" in str(e.value)


def test_mesh_2d_groups():
    """make_mesh_2d(2, 2): rank p * 2 + o at (p, o); the pose axis joins the
    ranks of one obs index, the obs axis those of one pose index."""
    outs = run_ranks(mesh_2d_rank, 4)
    for r, o in enumerate(outs):
        p, q = divmod(r, 2)
        assert o["coords"] == (p, q)
        assert o["pose"] == float(q + (2 + q)) and o["pose_gathered"] == [q, 2 + q]
        assert o["obs"] == float(2 * p + 2 * p + 1) and o["obs_gathered"] == [2 * p, 2 * p + 1]


def test_dryrun_multichip_prints_its_line(capsys):
    outs = tentry.dryrun_multichip(4, device="cpu")
    assert ("dryrun_multichip(4): sharded NMI (8, 4) + sharded BA + sharded pose graph ok"
            in capsys.readouterr().out)
    assert len(outs) == 4
    for o in outs:
        for k in ("nmi", "nmi_mesh", "ba_cam_Tcw", "pose_graph"):
            np.testing.assert_array_equal(o[k], outs[0][k])


def test_scaling_bench_writes_the_reference_keys(tmp_path):
    """Worlds of 1 and 2 gloo ranks, one timed run each: the JSON has
    SCALING_r05.json's keys."""
    out = tmp_path / "scaling.json"
    scaling_bench.run([1, 2], str(out), n_runs=1, device="cpu")
    table = json.loads(out.read_text())
    ref = json.loads((ROOT / "SCALING_r05.json").read_text())
    assert table["device_counts"] == [1, 2]
    assert set(ref["stages"]) >= set(table["stages"]) == {"nmi_s", "ba_s", "pose_graph_s"}
    keys = {"median_s", "cv", "min_s", "max_s", "n_runs", "overhead_factor",
            "efficiency_estimate"}
    for name, stage in table["stages"].items():
        assert set(stage) == keys and keys <= set(ref["stages"][name])
        assert stage["n_runs"] == 1 and set(stage["median_s"]) == {"1", "2"}
        assert all(v > 0 for v in stage["median_s"].values())
        assert stage["overhead_factor"]["1"] == 1.0
    assert table["device"]["platform"] == "cpu"


_BUILD_SCRIPT = r"""
import os, sys, time
from pathlib import Path
from orbslam2_nmi_torch import kernels
build_dir, log, started = map(Path, sys.argv[1:4])
kernels.BUILD_DIR = build_dir
kernels._nvcc = lambda: "nvcc-not-run"

def fake_compile(nvcc, so, verbose):
    # wait until the other process has started its build too, then take a while
    deadline = time.time() + 60
    while len(list(started.iterdir())) < 2 and time.time() < deadline:
        time.sleep(0.05)
    time.sleep(0.5)
    with open(log, "a") as f:
        f.write(f"{os.getpid()}\n")
    so.write_bytes(b"library")

kernels._compile = fake_compile
(started / str(os.getpid())).touch()
print(kernels.build())
"""


def test_kernel_build_is_safe_across_processes(tmp_path):
    """Two processes build at once (nvcc and the compile step faked): one
    compiles under the lock, the other waits for it and reuses the library."""
    (tmp_path / "started").mkdir()
    script = tmp_path / "build_kernels.py"
    script.write_text(_BUILD_SCRIPT)
    log = tmp_path / "compiled.log"
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, str(script), str(tmp_path / "build"), str(log),
                               str(tmp_path / "started")], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert len(log.read_text().split()) == 1  # compiled once
    paths = {out.strip().splitlines()[-1] for out in outs}
    assert len(paths) == 1 and Path(paths.pop()).read_bytes() == b"library"
    assert (tmp_path / "build" / "build.lock").exists()


# ------------------------------------------------------------------- the card


@pytest.mark.gpu
def test_nccl_world_of_one_rank_on_card(cuda_device):  # noqa: F811
    """A NCCL world of one rank runs the mesh NMI search through
    `render_gray` (B3 with the sampler fused), B2 and B1 once each, with the
    CPU's scores."""
    problems = {"nmi_mesh": sharding_mesh_problem()}
    card = run_ranks(sharding_rank, 1, problems, device="cuda")[0]
    cpu = run_ranks(sharding_rank, 1, problems, device="cpu")[0]
    assert card["launches"] == MESH_GRID_LAUNCHES
    np.testing.assert_allclose(card["nmi_mesh"], cpu["nmi_mesh"], atol=1e-5, rtol=0)


@pytest.mark.gpu
def test_gloo_ranks_share_one_card(cuda_device):  # noqa: F811
    """Two gloo ranks on cuda:0 (NCCL refuses two ranks on one card): the
    same scores as one rank, each rank launching each kernel once."""
    problems = {"nmi_mesh": sharding_mesh_problem()}
    two = run_ranks(sharding_rank, 2, problems, device="cuda", backend="gloo")
    one = run_ranks(sharding_rank, 1, problems, device="cuda")[0]
    for o in two:
        assert o["launches"] == MESH_GRID_LAUNCHES
        np.testing.assert_allclose(o["nmi_mesh"], one["nmi_mesh"], atol=1e-5, rtol=0)
