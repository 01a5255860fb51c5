"""Multi-host (jax.distributed) smoke: 2 CPU processes rendezvous, form the
global ("part",) mesh, and psum disjoint-support per-part deltas across the
process boundary — the DCN analogue of the in-process mesh reassembly tests
(SURVEY §2.3 "DCN across hosts"; reference has no multi-host story)."""

import os
import socket
import subprocess
import sys

import pytest

WORKER = r"""
import os, sys
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=4")
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, "/root/repo")
from delphy_tpu.parallel.distributed import (initialize_from_env,
                                             global_part_mesh)
assert initialize_from_env(), "distributed init did not trigger"
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P, NamedSharding
from jax import shard_map

assert jax.process_count() == 2, jax.process_count()
assert jax.local_device_count() == 4
mesh = global_part_mesh()
assert mesh.size == 8

# per-part deltas with disjoint support (each part owns a slice of the
# global vector), reassembled by the sweep's psum collective across DCN
pid = jax.process_index()
N = 16
local = np.zeros((4, 8, N))
for i in range(4):
    part = pid * 4 + i
    local[i, :, part * 2:(part + 1) * 2] = part + 1.0
g = jax.make_array_from_process_local_data(
    NamedSharding(mesh, P("part")), local, (8, 8, N))

def body(d):
    return jax.lax.psum(jnp.sum(d, axis=0), "part")

out = shard_map(body, mesh=mesh, in_specs=P("part"), out_specs=P())(g)
# disjoint support: each column slice is owned by exactly one part, so the
# psum reassembles the full vector without double counting
expect = np.zeros((8, N))
for part in range(8):
    expect[:, part * 2:(part + 1) * 2] = part + 1.0
got = np.asarray(jax.device_get(out.addressable_data(0)))
np.testing.assert_allclose(got, expect)
print("DIST_OK", pid, flush=True)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def test_two_process_mesh_psum():
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.pop("XLA_FLAGS", None)
        env["DELPHY_TPU_COORDINATOR"] = f"127.0.0.1:{port}"
        env["DELPHY_TPU_NUM_PROCESSES"] = "2"
        env["DELPHY_TPU_PROCESS_ID"] = str(pid)
        env["DELPHY_TPU_FORCE_CPU"] = "1"
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    for pr in procs:
        try:
            out, err = pr.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((pr.returncode, out, err))
    for pid, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"worker {pid} failed:\n{err[-3000:]}"
        assert f"DIST_OK {pid}" in out


PROD_WORKER = r"""
import os, sys
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count="
                           + os.environ["DELPHY_TEST_LOCAL_DEVICES"])
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, "/root/repo")
from delphy_tpu.parallel.distributed import (initialize_from_env,
                                             global_part_mesh)
distributed = initialize_from_env()
import jax
import numpy as np
from delphy_tpu.sim import simulate_dataset
from delphy_tpu.phylo import build_random_tree
from delphy_tpu.run import Run

mesh = global_part_mesh()
assert mesh.size == 8, mesh.size

# identical deterministic host program on every process: same dataset, same
# tree, same Run seed (the replicated-compute contract)
ref, deltas, miss, dates, names, _ = simulate_dataset(
    48, 400, mu=2e-3, missing_fraction=0.02, seed=21)
tree = build_random_tree(ref, deltas, miss, dates, names=names,
                         rng=np.random.default_rng(21))
run = Run(tree, seed=23, num_cells=64, local_moves_per_global_move=200,
          device_partitions=8, mesh=mesh, topology_moves_enabled=True)
run.topology_burst_chunks = 2     # force topology bursts into the window
run._multiprocess = True          # single-process reference: same blocking
                                  # drain + placement as the 2-process run
if distributed:
    assert jax.process_count() == 2
    assert run.pm.node_map.sharding.is_fully_addressable is False
for _ in range(4):
    run.do_mcmc_steps(400)
run.check_derived_quantities(1e-6)
assert run.topology_proposed > 0, "no topology burst ran in the window"
print("PROD", float(run.ledger.log_G), float(run.ledger.log_coal),
      int(run.local_moves_attempted), int(run.topology_proposed),
      float(run.ts.t[int(run.ts.root)]), flush=True)
"""


def test_two_process_production_run():
    """The PRODUCTION driver across 2 processes: both
    processes construct the partitioned Run from process-local part rows
    (make_array_from_process_local_data in the pack path), drive
    Run.do_mcmc_steps — sweeps under shard_map across the process boundary,
    replicated host topology bursts, restencils — and the final ledger
    matches a single-process 8-device run of the identical program."""
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.pop("XLA_FLAGS", None)
        env["DELPHY_TPU_COORDINATOR"] = f"127.0.0.1:{port}"
        env["DELPHY_TPU_NUM_PROCESSES"] = "2"
        env["DELPHY_TPU_PROCESS_ID"] = str(pid)
        env["DELPHY_TPU_FORCE_CPU"] = "1"
        env["DELPHY_TEST_LOCAL_DEVICES"] = "4"
        procs.append(subprocess.Popen(
            [sys.executable, "-c", PROD_WORKER], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    # single-process reference run of the same program on 8 virtual devices
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env.pop("DELPHY_TPU_COORDINATOR", None)
    env["DELPHY_TPU_FORCE_CPU"] = "1"
    env["DELPHY_TEST_LOCAL_DEVICES"] = "8"
    ref_proc = subprocess.Popen(
        [sys.executable, "-c", PROD_WORKER], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    outs = []
    for pr in procs + [ref_proc]:
        try:
            out, err = pr.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            for q in procs + [ref_proc]:
                q.kill()
            raise
        outs.append((pr.returncode, out, err))
    for i, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"worker {i} failed:\n{err[-4000:]}"
        assert "PROD " in out

    def parse(out):
        line = [ln for ln in out.splitlines() if ln.startswith("PROD ")][0]
        f = line.split()
        return (float(f[1]), float(f[2]), int(f[3]), int(f[4]), float(f[5]))

    p0, p1, ref = parse(outs[0][1]), parse(outs[1][1]), parse(outs[2][1])
    # the two processes of ONE run must agree bit-exactly (collectives hand
    # every participant the same values; host programs are deterministic)
    assert p0 == p1, (p0, p1)
    # cross-process collectives may associate float reductions differently
    # than the single-process backend, so the reference comparison allows
    # tiny float slack but pins the integer move counts exactly
    assert p0[2] == ref[2] and p0[3] == ref[3], (p0, ref)
    assert abs(p0[0] - ref[0]) < 1e-6 * max(1.0, abs(ref[0])), (p0, ref)
    assert abs(p0[1] - ref[1]) < 1e-6 * max(1.0, abs(ref[1])), (p0, ref)
    assert abs(p0[4] - ref[4]) < 1e-9 * max(1.0, abs(ref[4])), (p0, ref)
