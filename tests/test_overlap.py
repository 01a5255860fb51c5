"""Overlapped dispatch/burst driver: the device sweeps
one random half of the partition set while the host runs the topology burst
on the complement, both conditioning on the same frozen boundary values —
the reference's fork-join argument (core/run.cpp:682-693) with the device
and the host as the two workers.  Global parameter moves run in their own
non-overlapped boundary (no kernel reads params another writes)."""

import os

import numpy as np
import pytest

from delphy_tpu.sim import simulate_dataset
from delphy_tpu.phylo import build_random_tree
from delphy_tpu.run import Run


def make_run(seed=21, T=48, L=400, **kw):
    ref, deltas, miss, dates, names, _ = simulate_dataset(
        T, L, mu=2e-3, missing_fraction=0.02, seed=seed)
    tree = build_random_tree(ref, deltas, miss, dates, names=names,
                             rng=np.random.default_rng(seed))
    kw.setdefault("device_partitions", 8)
    return Run(tree, seed=seed + 2, num_cells=64,
               local_moves_per_global_move=200,
               topology_moves_enabled=True, **kw)


@pytest.fixture
def overlap_env(monkeypatch):
    monkeypatch.setenv("DELPHY_TPU_OVERLAP", "1")


def test_overlap_production_loop(overlap_env):
    """Drive several overlapped cycles; the ledger invariant, tree
    integrity and tip data must survive, topology must actually move, and
    the cycle must sweep + burst every round."""
    run = make_run()
    run.topology_burst_chunks = 2
    assert run._overlap_active()
    tip_seqs = [np.asarray(run._host_tree.sequence_at(i))
                for i in range(0, run._host_tree.num_tips, 7)]
    for _ in range(5):
        run.do_mcmc_steps(400)
    assert run.topology_proposed > 0
    assert run.local_moves_attempted > 400  # sweeps + bursts both counted
    run.check_derived_quantities(1e-6)
    tree = run.tree()
    tree.check_integrity()
    for j, i in enumerate(range(0, tree.num_tips, 7)):
        np.testing.assert_array_equal(np.asarray(tree.sequence_at(i)),
                                      tip_seqs[j])


def test_overlap_mixes_like_blocking(overlap_env):
    """Statistical smoke: overlapped and blocking drivers sample the same
    posterior.  Short windows, loose bounds — catches gross bias (wrong
    boundary freezing, double-counted deltas), not fine distributional
    error (tests/test_mcmc.py's oracle tests cover the kernels)."""
    n = 6000
    run_o = make_run(seed=5)
    run_o.topology_burst_chunks = 4
    run_o.do_mcmc_steps(n)
    lp_o = []
    for _ in range(30):
        run_o.do_mcmc_steps(n // 10)
        lp_o.append(run_o.log_posterior)

    os.environ["DELPHY_TPU_OVERLAP"] = "0"
    try:
        run_b = make_run(seed=5)
        run_b.topology_burst_chunks = 4
        run_b.do_mcmc_steps(n)
        lp_b = []
        for _ in range(30):
            run_b.do_mcmc_steps(n // 10)
            lp_b.append(run_b.log_posterior)
    finally:
        os.environ["DELPHY_TPU_OVERLAP"] = "1"

    mo, mb = np.mean(lp_o), np.mean(lp_b)
    s = max(np.std(lp_o), np.std(lp_b), 1.0)
    assert abs(mo - mb) < 6.0 * s, (mo, mb, s)


def _full_state(run):
    """Materialize every piece of Run state that the overlapped cycle
    touches, as host values (for exact-equality comparison)."""
    import jax
    ts = jax.tree.map(np.asarray, jax.device_get(run.ts))
    led = (float(run.ledger.log_G), float(run.ledger.log_coal),
           float(run.ledger.log_other))
    key = np.asarray(jax.device_get(run.key))
    rng_state = run.host_rng.bit_generator.state
    evo = jax.tree.map(np.asarray, jax.device_get(run.evo))
    return ts, led, key, rng_state, evo


def test_overlap_equals_sequential_execution(overlap_env, monkeypatch):
    """Exact fork-join correctness: an overlapped cycle
    (host burst running while the device dispatch is in flight) must produce
    BIT-IDENTICAL merged state to a sequential execution of the same frozen
    halves — same uniforms, same stencil, device half fully materialized
    before the host burst starts.  This is the overlap analogue of
    test_mesh_run_matches_single_device_run: if the burst read anything the
    in-flight dispatch was still writing, or the merge depended on timing,
    the states would diverge."""
    import jax
    from delphy_tpu.parallel import sweep as sweep_mod

    n_cycle = 2 * 200 * 2  # 2 boundaries x cadence, 2 cycles

    run_a = make_run(seed=13)
    run_a.topology_burst_chunks = 2
    assert run_a._overlap_active()
    run_a.do_mcmc_steps(n_cycle)  # warm: both runs pass the same prefix

    run_b = make_run(seed=13)
    run_b.topology_burst_chunks = 2
    run_b.do_mcmc_steps(n_cycle)

    # sanity: the two runs are identical before the cycle under test
    for x, y in zip(_full_state(run_a), _full_state(run_b)):
        np.testing.assert_equal(x, y)

    # run_a: normal overlapped cycle (dispatch in flight during the burst)
    run_a.do_mcmc_steps(n_cycle)

    # run_b: SEQUENTIAL execution — every sweep dispatch is forced to
    # complete before the host proceeds (so the burst runs strictly after
    # the device half has been fully computed and materialized)
    orig = sweep_mod.parts_multi_super_step

    def blocking_super_step(*args, **kw):
        out = orig(*args, **kw)
        return jax.block_until_ready(out)

    monkeypatch.setattr(sweep_mod, "parts_multi_super_step",
                        blocking_super_step)
    run_b.do_mcmc_steps(n_cycle)
    monkeypatch.setattr(sweep_mod, "parts_multi_super_step", orig)

    sa, sb = _full_state(run_a), _full_state(run_b)
    for name, x, y in zip(("ts", "ledger", "key", "rng", "evo"), sa, sb):
        np.testing.assert_equal(x, y, err_msg=f"overlap vs sequential: {name}")


def test_overlap_mesh_matches_single_device(overlap_env):
    """Overlapped cycles under a ("part",) mesh are bit-identical to the
    single-device overlapped run (the A/B gather runs on global arrays
    before shard_map).
    device_partitions=16 keeps the selection width (P//2 = 8) identical
    with and without the 8-way mesh, so trajectories must match exactly."""
    import jax
    from jax.sharding import Mesh

    devs = jax.devices()
    assert len(devs) >= 8, "conftest must provide 8 CPU devices"
    mesh = Mesh(np.array(devs[:8]), axis_names=("part",))

    def drive(m):
        run = make_run(seed=17, device_partitions=16, mesh=m)
        run.topology_burst_chunks = 2
        assert run._overlap_active()
        run.do_mcmc_steps(1600)
        return run

    r_mesh = drive(mesh)
    r_one = drive(None)
    assert float(r_mesh.ledger.log_G) == float(r_one.ledger.log_G)
    assert np.array_equal(np.asarray(r_mesh.ts.t), np.asarray(r_one.ts.t))
    assert np.array_equal(np.asarray(r_mesh.ts.mut_t),
                          np.asarray(r_one.ts.mut_t))
    assert r_mesh.topology_proposed == r_one.topology_proposed
    r_mesh.check_derived_quantities(1e-6)


def test_overlap_skygrid_cycle(overlap_env):
    """The overlapped cycle under the skygrid pop model (host pop rebuild +
    HostCoalGrid refresh paths differ from exp)."""
    run = make_run(seed=9, T=32, L=300, pop_model="skygrid",
                   skygrid_num_parameters=8)
    run.topology_burst_chunks = 2
    assert run._overlap_active()
    for _ in range(3):
        run.do_mcmc_steps(400)
    assert run.topology_proposed > 0
    run.check_derived_quantities(1e-6)
    run.tree().check_integrity()
