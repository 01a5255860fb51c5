"""Multi-device (mesh) tests for the partitioned engine, on the virtual
8-device CPU mesh (conftest).  These are the in-tree analogues of the
reference's parallel-correctness invariants
(check_global_and_local_totals_match, core/run.cpp:340-357), validated here
under real shard_map + psum collectives rather than threads."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from delphy_tpu.sim import simulate_dataset
from delphy_tpu.phylo import build_random_tree
from delphy_tpu.run import Run
from delphy_tpu.ops import likelihood as lk
from delphy_tpu.ops import coalescent as coal
from delphy_tpu.mcmc import global_moves as gm
from delphy_tpu.parallel.sweep import (make_mesh_multi_super_step,
                                       parts_multi_super_step)
from delphy_tpu.parallel import vsc_device as vsc


def make_run(seed=3, T=24, L=200, P_parts=8, cells=64):
    ref, deltas, miss, dates, names, _ = simulate_dataset(T, L, mu=2e-3,
                                                          seed=seed)
    tree = build_random_tree(ref, deltas, miss, dates, names=names,
                             rng=np.random.default_rng(seed))
    return Run(tree, seed=seed + 2, num_cells=cells,
               local_moves_per_global_move=200, device_partitions=P_parts,
               topology_moves_enabled=False)


@pytest.fixture(scope="module")
def mesh8():
    devs = jax.devices()
    assert len(devs) >= 8, "conftest must provide 8 CPU devices"
    return Mesh(np.array(devs[:8]), axis_names=("part",))


def test_mesh_step_matches_vmap_exactly(mesh8):
    """ONE chain, tree partitioned over 8 devices: the shard_map+psum path
    must be bit-identical to the single-device vmap path (the reassembly
    collective carries exactly the reference's memcpy reassemble,
    run.cpp:195-275)."""
    run = make_run()
    assert run.pm.node_map.shape[0] == 8
    args = (run.ts, run.evo, run.pop, run.key, run.tin, run.tout, run.pm,
            4, run.t_max_tip)

    step = make_mesh_multi_super_step(mesh8, run.hyp, run.num_cells, 2,
                                      run._sweep_k_max,
                                      run._sweep_reform_batch)
    ts_m, evo_m, pop_m, key_m, ledger_m, stats_m = step(*args)

    ts_v, evo_v, pop_v, key_v, ledger_v, stats_v, _fused = parts_multi_super_step(
        run.ts, run.evo, run.pop, run.key, run.tin, run.tout, run.pm, 4,
        run.t_max_tip, run.hyp, run.num_cells, 2, run._sweep_k_max,
        run._sweep_reform_batch)

    assert int(stats_m["local_moves_attempted"]) > 0
    assert jnp.array_equal(ts_m.t, ts_v.t)
    assert jnp.array_equal(ts_m.mut_t, ts_v.mut_t)
    assert float(ledger_m.log_G) == float(ledger_v.log_G)
    assert float(ledger_m.log_coal) == float(ledger_v.log_coal)
    assert int(stats_m["local_moves_attempted"]) == \
        int(stats_v["local_moves_attempted"])


def test_mesh_kbar_totals_match_global(mesh8):
    """Sum of per-part signed lineage staircases under psum == the global
    k_bar staircase (the totals-match invariant, run.cpp:340-357; sign
    algebra of partmaps.PartMaps.sign)."""
    run = make_run(seed=11, T=32)
    pm, ts = run.pm, run.ts
    C = run.num_cells
    t_root = float(ts.t[ts.root])
    span = max(run.t_max_tip - t_root, 1.0)
    t_lo = t_root - 0.35 * span - 1.0
    t_step = (run.t_max_tip - t_lo) / C
    t_lo, t_step = jnp.float64(t_lo), jnp.float64(t_step)

    nm = jnp.maximum(pm.node_map, 0)
    t_p = ts.t[nm]

    def body(t_p_s, sign_s):
        k_p = jax.vmap(vsc.calc_k_bar_signed,
                       in_axes=(0, 0, None, None, None))(
            t_p_s, sign_s, t_lo, t_step, C)
        return jax.lax.psum(jnp.sum(k_p, axis=0), "part")

    k_total = jax.jit(shard_map(
        body, mesh=mesh8, in_specs=(P("part"), P("part")),
        out_specs=P()))(t_p, pm.sign)

    k_global = coal.calc_k_bar(ts.t, ts.is_tip, t_lo, t_step, C)
    # global k_bar counts the root lineage extending into the past the same
    # way the run-root part's -1 sign does
    np.testing.assert_allclose(np.asarray(k_total), np.asarray(k_global),
                               atol=1e-9)


def test_mesh_production_loop(mesh8):
    """The FULL production loop under the mesh: Run(mesh=...) drives
    do_mcmc_steps with topology bursts, multi-site chain reform, restencils
    and partitioned sweeps across the 8 CPU devices — the user-reachable
    multi-chip path (reference driver: run.cpp:622-693).  Asserts >= 3
    topology bursts actually ran, the incremental log_G ledger survives the
    whole loop, and tree integrity + tip data are preserved."""
    ref, deltas, miss, dates, names, _ = simulate_dataset(
        48, 400, mu=2e-3, missing_fraction=0.02, seed=21)
    tree = build_random_tree(ref, deltas, miss, dates, names=names,
                             rng=np.random.default_rng(21))
    run = Run(tree, seed=23, num_cells=64, local_moves_per_global_move=200,
              device_partitions=8, mesh=mesh8, topology_moves_enabled=True)
    run.topology_burst_chunks = 2  # force frequent bursts
    assert run.pm.node_map.shape[0] == 8
    bursts = 0
    for _ in range(6):
        before = run.topology_proposed
        run.do_mcmc_steps(1200)
        bursts += int(run.topology_proposed > before)
    assert bursts >= 3, f"only {bursts} topology bursts ran under the mesh"
    assert run.topology_proposed > 0
    run.check_derived_quantities(tol=1e-6)
    out = run.tree()
    out.check_integrity()
    # tip data preserved through mesh sweeps + bursts (missing sites are
    # imputed by the sampler and legitimately change)
    for i in range(5):
        seq_a, seq_b = out.sequence_at(i), tree.sequence_at(i)
        observed = np.ones(len(seq_a), bool)
        for l in out.missing_sites_at(i):
            observed[l] = False
        np.testing.assert_array_equal(seq_a[observed], seq_b[observed])


def test_mesh_run_matches_single_device_run(mesh8):
    """Run(mesh=...) and Run(mesh=None) produce bit-identical trajectories
    for the same seed (sweep RNG is per-part, reassembly is exact)."""
    def drive(mesh):
        ref, deltas, miss, dates, names, _ = simulate_dataset(
            24, 200, mu=2e-3, seed=5)
        tree = build_random_tree(ref, deltas, miss, dates, names=names,
                                 rng=np.random.default_rng(5))
        run = Run(tree, seed=9, num_cells=64,
                  local_moves_per_global_move=200, device_partitions=8,
                  mesh=mesh, topology_moves_enabled=True)
        run.do_mcmc_steps(2400)
        return run

    r_mesh = drive(mesh8)
    r_one = drive(None)
    assert float(r_mesh.ledger.log_G) == float(r_one.ledger.log_G)
    assert np.array_equal(np.asarray(r_mesh.ts.t), np.asarray(r_one.ts.t))
    assert r_mesh.topology_proposed == r_one.topology_proposed


def test_mesh_determinism_and_ledger_invariant(mesh8):
    """Same seed + same mesh => identical trajectories (determinism contract,
    SURVEY A.9); and after mesh sweeps, incremental log_G equals the full
    recompute (run.cpp:316-338 discipline)."""
    run = make_run(seed=7, T=24)
    args = (run.ts, run.evo, run.pop, run.key, run.tin, run.tout, run.pm,
            4, run.t_max_tip)
    step = make_mesh_multi_super_step(mesh8, run.hyp, run.num_cells, 3,
                                      run._sweep_k_max,
                                      run._sweep_reform_batch)
    out1 = step(*args)
    out2 = step(*args)
    for a, b in zip(jax.tree.leaves(out1[:5]), jax.tree.leaves(out2[:5])):
        assert jnp.array_equal(a, b)

    ts, evo, pop_params, _key, ledger, _stats = out1
    caches = gm.compute_caches(ts, evo)
    log_G = lk.calc_log_G(ts, evo, caches.lambda_i, caches.root_freq)
    assert abs(float(ledger.log_G) - float(log_G)) < 1e-6


def test_cli_mesh_end_to_end(tmp_path):
    """The user-reachable multi-chip path: `--mesh-devices 8` through the
    full CLI (MAPLE in, BEAST log/trees out) on the 8-device CPU mesh —
    the reference driver run.cpp:622-693 as one shard_map'ed program."""
    import os
    import subprocess
    import sys

    from delphy_tpu.io.fasta import TipData
    from delphy_tpu.io.maple import write_maple
    from delphy_tpu.dates import to_iso_date

    ref, deltas, miss, dates, names, _ = simulate_dataset(
        16, 150, mu=2e-3, missing_fraction=0.02, seed=11)
    tips = [TipData(name=f"s{i}|{to_iso_date(dates[i][0])}", t_min=dates[i][0],
                    t_max=dates[i][1], deltas=deltas[i],
                    miss_intervals=miss[i])
            for i in range(16)]
    mp = tmp_path / "in.maple"
    write_maple(mp, "ref", ref, tips)

    log_f = tmp_path / "out.log"
    env = dict(os.environ)
    env["DELPHY_TPU_FORCE_CPU"] = "1"
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_force_host_platform_device_count=8")
    r = subprocess.run(
        [sys.executable, "-m", "delphy_tpu.cli",
         "--v0-in-maple", str(mp), "--v0-steps", "4000",
         "--mesh-devices", "8",
         "--v0-out-log-file", str(log_f), "--v0-seed", "13"],
        capture_output=True, text=True, timeout=900, env=env,
        cwd="/root/repo")
    assert r.returncode == 0, r.stderr[-3000:]
    assert "Sharding partitioned sweeps over 8 devices" in r.stderr
    log_lines = log_f.read_text().strip().split("\n")
    assert log_lines[0].startswith("Sample\tposterior")
    assert len(log_lines) >= 2


def test_mesh_dispatches_compile_once(mesh8):
    """Host-rebuilt state (a topology burst repacks ts; a parameter setter)
    must enter the mesh program with the same shardings as its replicated
    outputs, so a run's later dispatches reuse the first compile."""
    ref, deltas, miss, dates, names, _ = simulate_dataset(24, 200, mu=2e-3,
                                                          seed=5)
    tree = build_random_tree(ref, deltas, miss, dates, names=names,
                             rng=np.random.default_rng(5))
    run = Run(tree, seed=6, num_cells=64, local_moves_per_global_move=200,
              device_partitions=8, mesh=mesh8, topology_moves_enabled=True)
    run.topology_burst_chunks = 2
    run.set_mu(float(run.evo.mu))       # as the CLI sets its initial values
    assert run.evo.mu.sharding.is_equivalent_to(run.ts.t.sharding, 0)
    bursts = []
    burst = run._topology_burst
    run._topology_burst = lambda n: (bursts.append(n), burst(n))
    run.do_mcmc_steps(4 * run.local_moves_per_global_move)
    n_compiled = parts_multi_super_step._cache_size()
    for _ in range(2):
        run.do_mcmc_steps(4 * run.local_moves_per_global_move)
    assert len(bursts) >= 2
    assert parts_multi_super_step._cache_size() == n_compiled
    run.check_derived_quantities(1e-6)
