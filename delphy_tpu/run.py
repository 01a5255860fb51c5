"""MCMC run driver (host side).

Owns the device state and the step/cadence bookkeeping; each
`do_mcmc_steps` call dispatches jitted super-steps (global boundary + local
sweep).  Mirrors the reference's Run (core/run.{h,cpp}) minus the thread-pool
partition machinery (partition parallelism arrives via a device mesh instead).
"""

from __future__ import annotations

import math

import numpy as np
import jax
import jax.numpy as jnp

from .phylo import FlatTree
from .state import pack_state, unpack_state, TreeState
from .evo import make_evo_params, EvoParams
from . import pop as popm
from .ops import likelihood as lk
from .ops import coalescent as coal
from .mcmc import global_moves as gm
from .mcmc.global_moves import PriorConfig
from .mcmc.moves import Ledger
from .parallel.partmaps import build_part_maps, pad_part_maps, host_mut_nodes, \
    auto_num_partitions
from .parallel.sweep import parts_multi_super_step


# cap on sweep blocks per boundary (n_blocks is a traced argument, so the
# adaptive budget below never recompiles)
MAX_BLOCKS = 512


def _round_cap(n: int) -> int:
    return (max(n, 64) + 127) // 128 * 128


def _round_cap8(n: int) -> int:
    return (max(n, 8) + 7) // 8 * 8


def _round16(n: int) -> int:
    return (max(n, 16) + 15) // 16 * 16


from functools import partial as _partial


@_partial(jax.jit, static_argnames=("num_cells", "hyp"))
def _calc_ledger_jit(ts, evo, pop_params, t_max_tip, num_cells, hyp):
    """One-program from-scratch ledger recompute (see Run.calc_cur_ledger)."""
    caches = gm.compute_caches(ts, evo)
    log_G = lk.calc_log_G(ts, evo, caches.lambda_i, caches.root_freq)
    t_root = ts.t[ts.root]
    span = jnp.maximum(t_max_tip - t_root, 1.0)
    t_lo = t_root - 0.35 * span - 1.0
    t_step = (t_max_tip - t_lo) / num_cells
    grid = coal.make_grid(pop_params, ts.t, ts.is_tip, t_lo, t_step,
                          num_cells)
    log_coal = coal.calc_log_prior(grid, pop_params, ts.t, ts.is_tip)
    log_other = gm.calc_log_other_priors(evo, pop_params, hyp)
    return Ledger(log_G=log_G, log_coal=log_coal, log_other=log_other)


class Run:
    def __init__(self, tree: FlatTree, seed: int = 0, hyp: PriorConfig = PriorConfig(),
                 num_cells: int = 512, local_moves_per_global_move: int = -1,
                 topology_moves_enabled: bool = True,
                 topology_partitions: int = 0,
                 topology_parallel_processes: bool = True,
                 device_partitions: int = 0,
                 mesh=None,
                 pop_model: str = "exp", skygrid_num_parameters: int = 50,
                 skygrid_cutoff_days: float | None = None,
                 skygrid_type: int = popm.STAIRCASE,
                 skygrid_x0_days: float | None = None,
                 skygrid_xM_days: float | None = None,
                 skygrid_tau: float | None = None,
                 skygrid_double_half_time_days: float | None = None,
                 skygrid_init_nbar_days: float = 3.0 * 365.0,
                 mpox_hack: bool = False):
        tree.check_integrity()
        # Run owns its tree: topology bursts and repartition syncs mutate it
        # in place, so sharing one FlatTree across Runs must be safe
        tree = tree.copy()
        self.names = list(tree.name)
        # generous pool headroom so topology moves rarely force a reshape
        # (shape changes re-jit the sweep kernel)
        n_muts = tree.num_mutations() + len(tree.mutations[tree.root])
        self.mut_capacity = _round_cap(2 * n_muts + 256)
        n_ivs = sum(len(iv) for iv in tree.miss_intervals)
        self.miss_capacity = _round_cap(2 * n_ivs + 128)
        n_fs = sum(len(fs) for fs in tree.miss_from_states)
        self.fs_capacity = _round_cap(4 * n_fs + 128)
        self.ts: TreeState = pack_state(tree, self.mut_capacity,
                                        self.miss_capacity, self.fs_capacity)
        # fused (ints, floats) copy of (ts, evo, pop) produced by the last
        # sweep dispatch; None whenever host code has since replaced any of
        # the three (the burst falls back to a fresh fused fetch)
        self._fused_bundle = None
        self.hyp = hyp
        self.num_cells = num_cells
        self.topology_moves_enabled = topology_moves_enabled
        self.topology_partitions = topology_partitions
        self.topology_parallel_processes = topology_parallel_processes
        # amortize per-burst fixed costs (partitioning, transfers, pack/unpack)
        # by accumulating the topology-move budget over several boundaries:
        # small trees take big chunks (~1M local moves per cycle).  Up to
        # 2M local moves per boundary (~20k tips) bursts interleave every
        # 2+ boundaries, which trades moves/s for per-move mixing (ESS/hour
        # decides); larger trees amortize over 32 boundaries, and above 6M
        # (~60k tips) the driver defaults to the OVERLAPPED cycle
        # (_overlap_active), which bursts every cycle.  These gates were
        # fitted on an earlier accelerator and host and are to be
        # re-derived on this one (ROADMAP).
        self.topology_burst_chunks = 32  # reset below once cadence is known
        # restencil cadence is DECOUPLED from topology_burst_chunks: raising
        # the burst chunk count for small trees must not also stretch how
        # often frozen cut-point times get resampled (the slow-switching
        # argument of run.cpp:87-108 assumes a steady refresh interval).
        # Default 200 boundaries = the reference's own stencil-refresh
        # cadence (200 * local_moves_per_global_move, run.cpp:106); a
        # shorter interval forces more dispatches plus a host restencil
        # (device sync + map rebuild + re-upload) per dispatch at small-tree
        # shapes
        import os as _os
        self.restencil_interval = int(
            _os.environ.get("DELPHY_TPU_RESTENCIL", "200"))
        self._topo_debt = 0
        self.host_rng = np.random.default_rng(np.uint64(seed) + 0x9E3779B97F4A7C15)
        self.topology_accepted = 0
        self.topology_proposed = 0
        N = self.ts.num_nodes
        self.local_moves_per_global_move = (
            50 * N if local_moves_per_global_move == -1 else local_moves_per_global_move)
        lm = max(1, self.local_moves_per_global_move)
        if lm <= 2_000_000:  # T <~ 20k tips: interleave (see comment above)
            self.topology_burst_chunks = max(2, min(256, 2_000_000 // lm))
        else:  # very large trees: amortize (measured at 100k tips)
            self.topology_burst_chunks = 32

        self.mpox_hack = mpox_hack
        if mpox_hack:
            # 2-partition APOBEC model (reference set_mpox_hack_enabled,
            # run.cpp:359-398): partitions from the first tip's sequence,
            # JC rates with uniform pi, rho = mu_star/mu starts at 0
            import dataclasses
            from .evo import apobec_context_partition
            part = apobec_context_partition(tree.sequence_at(0))
            self.hyp = hyp = dataclasses.replace(hyp, mpox_enabled=True)
            self.evo = make_evo_params(
                tree.num_sites, mu=1e-3 / 365.0, kappa=1.0,
                pi=np.full(4, 0.25), alpha=10.0,
                part=part).with_mpox_rho(rho=0.0)
        else:
            # initial HKY pi from ref-sequence state frequencies (run.cpp:61-80)
            freq = np.bincount(np.asarray(tree.ref_seq),
                               minlength=4).astype(np.float64)
            est_pi = freq / freq.sum()
            if est_pi.min() < 0.01 or est_pi.max() > 0.99:
                est_pi = np.full(4, 0.25)
            self.evo = make_evo_params(
                tree.num_sites, mu=1e-3 / 365.0, kappa=1.0, pi=est_pi,
                alpha=10.0)

        t_max_tip = float(np.max(tree.t_max[:tree.num_tips]))
        self.t_max_tip = t_max_tip
        if pop_model == "exp":
            # default: Exp(t0 = max tip time, n0=1000, g=0, min_pop=1) (run.cpp:21)
            self.pop = popm.ExpPopParams(
                t0=jnp.float64(t_max_tip), n0=jnp.float64(1000.0),
                g=jnp.float64(0.0), min_pop=jnp.float64(1.0))
        elif pop_model == "skygrid":
            # knots: explicit first/last dates (cmdline.cpp:947-993), else
            # x_k = T - (M-k)/M * K (pop_model.h:144-147); default cutoff:
            # 1.2x the initial tree span
            M = max(1, skygrid_num_parameters - 1)
            t_root0 = float(tree.t[tree.root])
            if skygrid_x0_days is not None and skygrid_xM_days is not None:
                if skygrid_x0_days >= skygrid_xM_days:
                    raise ValueError("skygrid first knot must precede last")
                x = skygrid_x0_days + np.arange(M + 1, dtype=np.float64) / M \
                    * (skygrid_xM_days - skygrid_x0_days)
            else:
                K = (skygrid_cutoff_days if skygrid_cutoff_days
                     else 1.2 * max(t_max_tip - t_root0, 1.0))
                x = t_max_tip - (M - np.arange(M + 1, dtype=np.float64)) / M * K
            if skygrid_tau is not None:
                tau0 = float(skygrid_tau)
            elif skygrid_double_half_time_days is not None:
                # random-walk diffusion D = log^2(2)/(2 T_dh); tau = 1/(2 D dt)
                # (cmdline.cpp:1026-1045)
                dt_knot = (x[-1] - x[0]) / M
                D = math.log(2.0) ** 2 / (2.0 * skygrid_double_half_time_days)
                tau0 = 1.0 / (2.0 * D * dt_knot)
            else:
                tau0 = 1.0
            # initial gamma: random walk at precision tau, recentered to the
            # initial N_bar (cmdline.cpp:1140-1153; the zero-mode Gibbs move
            # resamples the mean, so only the shape matters)
            g = np.concatenate([[0.0], np.cumsum(
                self.host_rng.normal(0.0, np.sqrt(1.0 / tau0), M))])
            g += -g.mean() + np.log(skygrid_init_nbar_days)
            self.pop = popm.SkygridPopParams(
                x=jnp.asarray(x), gamma=jnp.asarray(g),
                type=skygrid_type, tau=jnp.float64(tau0))
        else:
            raise ValueError(f"unknown pop_model {pop_model!r}")

        tin, tout = tree.euler_positions()
        self.tin, self.tout = jnp.asarray(tin), jnp.asarray(tout)

        # device tree-partitioning (the reference's execution parallelism,
        # run.cpp:682-693, re-designed as vmapped/shard_map'ed part sweeps).
        # With a jax.sharding.Mesh (axis "part"), the sweep runs under
        # shard_map across its devices with psum reassembly; the partition
        # count must then divide evenly over the mesh.
        self.mesh = mesh
        if mesh is not None and tuple(mesh.axis_names) != ("part",):
            raise ValueError('Run mesh must have a single "part" axis')
        # multi-host (DCN) regime: the mesh spans >1 JAX process.  Every
        # process runs this same deterministic host program (replicated
        # compute), while device arrays become GLOBAL jax.Arrays — partition
        # maps sharded over "part" from process-local rows, everything else
        # replicated.  See parallel/distributed.py.
        from .parallel.distributed import mesh_spans_processes
        self._multiprocess = mesh is not None and mesh_spans_processes(mesh)
        self.device_partitions = (device_partitions if device_partitions > 0
                                  else auto_num_partitions(tree.num_tips))
        if mesh is not None:
            D = int(mesh.size)
            self.device_partitions = max(
                D, (self.device_partitions + D - 1) // D * D)
        self._host_tree = tree          # topology/t synced at repartition
        self._n_cap_sticky = 0
        self._m_cap_sticky = 0
        self._P_sticky = 0
        self.pm = None
        self._boundaries_since_repart = 0
        self._repartition()

        self.key = jax.random.PRNGKey(seed)
        self.step = 0
        self._attempted_done = 0
        # in-flight dispatch results not yet synced: (device_count, boundaries,
        # n_blocks) triples, drained lazily so dispatches pipeline instead of
        # forcing a host<->device round-trip each
        self._inflight: list = []
        self.ledger: Ledger | None = None
        self.last_stats = None
        if self.mesh is not None:
            self._place_replicated()

    def _place_replicated(self):
        """Lift host-built state to replicated arrays over the mesh — the
        sharding the mesh program returns its outputs in, so later
        dispatches reuse the first compile.  Multi-host: GLOBAL arrays, each
        process supplying identical values (the deterministic replicated
        host program is the broadcast)."""
        from .parallel.distributed import replicate_to_mesh
        (self.ts, self.evo, self.pop, self.tin, self.tout,
         self.key) = replicate_to_mesh(
            (self.ts, self.evo, self.pop, self.tin, self.tout, self.key),
            self.mesh)

    # -- lazy attempted-move accounting -------------------------------------

    def _drain_inflight(self, block: bool = True):
        """Consume finished dispatch stats; with block=False only those
        already on host."""
        keep = []
        for arr, boundaries, n_blocks in self._inflight:
            if not block and not arr.is_ready():
                keep.append((arr, boundaries, n_blocks))
                continue
            attempted = int(arr)
            self._attempted_done += attempted
            measured = attempted / (boundaries * n_blocks)
            self._per_block_rate = max(
                1.0, 0.7 * self._per_block_rate + 0.3 * measured)
        self._inflight = keep

    @property
    def local_moves_attempted(self) -> int:
        self._drain_inflight(block=True)
        return self._attempted_done

    @local_moves_attempted.setter
    def local_moves_attempted(self, v: int):
        self._inflight.clear()
        self._attempted_done = v

    def _repartition(self, sync_times: bool = False):
        """(Re)build the device partition maps from the current tree
        (Run::repartition, run.cpp:110-190).  Called at init and after every
        topology burst; also periodically so frozen cut-point times get
        resampled (the slow-switching argument of run.cpp:87-108)."""
        tree = self._host_tree
        if sync_times:
            tree.t = np.asarray(jax.device_get(self.ts.t), dtype=np.float64).copy()
        P = self.device_partitions
        pm, self._last_cuts = build_part_maps(
            tree, host_mut_nodes(tree, self.mut_capacity), P, self.host_rng,
            return_cuts=True)
        # the oversized-part splitter (partmaps.py) can RAISE the actual
        # part count above the requested stencil size; pad the part axis to
        # a sticky width (8-aligned, mesh-divisible) so jit shapes stay put.
        # When the splitter never fires this reduces to the old exact-P pad.
        D = int(self.mesh.size) if self.mesh is not None else 1

        def _round_parts(p):
            q = (p + 7) // 8 * 8
            return (q + D - 1) // D * D
        if self._P_sticky < P:
            self._P_sticky = P
        if pm.num_parts > self._P_sticky:
            self._P_sticky = _round_parts(int(1.1 * pm.num_parts))
        P = self._P_sticky
        if self._n_cap_sticky == 0:
            # headroom for stencil-to-stencil variation (with best-of-K
            # stencils the max part size varies ~10% at 10k tips)
            self._n_cap_sticky = _round16(int(1.4 * pm.n_cap) + 16)
            if P > 1:
                # the oversized-part splitter bounds EVERY stencil's worst
                # part at part_size_cap(), so headroom above it is dead
                # compute
                from .parallel.partmaps import part_size_cap
                hard = _round16(max(part_size_cap(), pm.n_cap))
                if self._n_cap_sticky > hard:
                    self._n_cap_sticky = hard
            self._m_cap_sticky = _round16(2 * pm.m_cap + 16)
        # quantized growth so cap bumps (=> recompiles) are rare
        if pm.n_cap > self._n_cap_sticky:
            self._n_cap_sticky = _round16(int(1.5 * pm.n_cap))
        if pm.m_cap > self._m_cap_sticky:
            self._m_cap_sticky = _round16(int(1.5 * pm.m_cap))
        pm = pad_part_maps(pm, P, self._n_cap_sticky, self._m_cap_sticky,
                           tree.num_nodes, self.mut_capacity)
        if getattr(self, "_multiprocess", False):
            from .parallel.distributed import shard_parts_to_mesh
            self.pm = shard_parts_to_mesh(pm, self.mesh)
        else:
            self.pm = jax.tree.map(jnp.asarray, pm)
        n_cap = self._n_cap_sticky
        self._sweep_k_max = n_cap
        self._sweep_reform_batch = max(4, n_cap // 2)  # budgeting only
        # initial attempted-moves-per-(block x all parts) estimate; refined
        # online from sweep stats (see do_mcmc_steps)
        if not hasattr(self, "_per_block_rate") or self._per_block_rate <= 1.0:
            P = self.device_partitions
            self._per_block_rate = float(P * (1 + n_cap // 4 + n_cap // 2))

    # -- parameter setters (subset of the reference's Run API) --------------

    def _param(self, v: float):
        """A parameter scalar placed as the dispatch expects it (replicated
        over the mesh, if any), so a setter does not force a recompile."""
        x = jnp.float64(v)
        if self.mesh is None:
            return x
        from .parallel.distributed import replicate_to_mesh
        return replicate_to_mesh(x, self.mesh)

    def set_mu(self, mu: float):
        self.evo = self.evo._replace(mu=self._param(mu))
        self._fused_bundle = None

    def set_alpha(self, alpha: float):
        self.evo = self.evo._replace(alpha=self._param(alpha))
        self._fused_bundle = None

    def set_pop(self, n0=None, g=None, min_pop=None):
        if n0 is not None:
            self.pop = self.pop._replace(n0=self._param(n0))
        if g is not None:
            self.pop = self.pop._replace(g=self._param(g))
        if min_pop is not None:
            self.pop = self.pop._replace(min_pop=self._param(min_pop))
        self._fused_bundle = None

    # -- MCMC ---------------------------------------------------------------

    def _overlap_active(self) -> bool:
        """Overlapped dispatch/burst mode: device sweeps one random half of
        the partition set while the host runs the topology burst on the
        complement.  Valid because both halves condition
        on the same frozen boundary values — the same fork-join argument as
        the reference's thread fan-out (run.cpp:682-693), with the device and
        the host as the two workers.  Global parameter moves run in their own
        (non-overlapped) boundary so no kernel reads params another writes."""
        import os
        env = os.environ.get("DELPHY_TPU_OVERLAP", "auto")
        if env == "0":
            return False
        if env == "auto" and self.local_moves_per_global_move <= 6_000_000:
            # overlap only above 6M local moves per boundary (~>60k tips):
            # below that its per-cycle fixed costs and its coupling to the
            # user's sampling cadence outweigh the hidden burst time.  The
            # gate was fitted on an earlier accelerator and host (ROADMAP
            # speed item 7 re-derives it).
            return False
        n_real = len(self._last_cuts) + 1
        # single-process meshes overlap (the A/B gather happens on global
        # arrays before shard_map, sweep.py); multi-process meshes keep the
        # blocking driver: the overlap path's host burst would need
        # process-0 gating + a result broadcast — machinery the blocking
        # path already has and the overlap path does not (see NOTES.md).
        return (self.topology_moves_enabled
                and not self._multiprocess and n_real >= 4)

    def _do_mcmc_steps_overlapped(self, n_steps: int):
        """Overlap cycles: [G: one globals boundary] -> enqueue
        [L: locals-only boundaries on device-half A] -> host burst on
        complement-half B (concurrent with L) -> merge -> repartition."""
        from .topo.parallel import run_bursts_on_parts
        from .topo.partition import partition_tree, reassemble
        from .topo.mixer import HostExpPop, HostSkygridPop, HostCoalGrid
        from .topo.reform import resample_multi_site_chains
        from .phylo import rereference_to_root_sequence
        from .state import split_for_host, fetch_fused
        import os as _os

        cadence = self.local_moves_per_global_move
        # overlapped cycles default to a BIGGER dispatch cap than blocking
        # (96M vs 32M): the fixed merge costs are per-cycle, so more
        # boundaries per cycle amortize them.
        max_dispatch = int(_os.environ.get("DELPHY_TPU_MAX_DISPATCH_MOVES",
                                           str(96_000_000)))
        _verbose = _os.environ.get("DELPHY_TPU_BURST_VERBOSE") == "1"
        import time as _time
        _tl = [_time.monotonic()]

        def _stage(name):
            if not _verbose:
                return
            now = _time.monotonic()
            print(f"[overlap] {name}: {now - _tl[0]:.3f}s", flush=True)
            _tl[0] = now
        done = 0
        while done < n_steps:
            remaining = n_steps - done
            boundaries = max(1, min(self.topology_burst_chunks,
                                    self.restencil_interval,
                                    max(1, max_dispatch // max(1, cadence)),
                                    remaining // cadence))
            chunk = min(remaining, boundaries * cadence)
            per_boundary = (chunk + boundaries - 1) // boundaries

            # host tree must mirror the device state (steady state: it does,
            # the merge below repacks it; entering from the non-overlap path:
            # sync once from the fused bundle)
            if self._fused_bundle is not None:
                ints_h, flts_h = jax.device_get(self._fused_bundle)
                ts_h, _evo_h, _pop_h = split_for_host(
                    (self.ts, self.evo, self.pop), ints_h, flts_h)
                self._host_tree = unpack_state(ts_h, names=self.names)
                self._fused_bundle = None
                self._repartition()
            tree = self._host_tree

            # A/B split over the REAL parts of the current stencil
            P_sticky = self.pm.node_map.shape[0]
            n_real = len(self._last_cuts) + 1
            W = max(1, P_sticky // 2)
            if self.mesh is not None:  # selection width shards over the mesh
                D = int(self.mesh.size)
                W = max(D, W // D * D)
            perm = self.host_rng.permutation(n_real)
            n_dev = min(W, max(1, n_real - 1))
            A = np.sort(perm[:n_dev])
            B = np.sort(perm[n_dev:])
            sel = np.full(W, n_real, np.int32)  # pad rows (n_nodes=0) no-op
            sel[:n_dev] = A
            assert P_sticky > n_real or n_dev == W, \
                "selection width exceeds real parts with no padding rows"

            # G: one globals-only boundary (params + full ledger recompute)
            from .parallel.sweep import parts_multi_super_step
            (ts_g, evo_g, pop_g, key_g, _ledger_g, _stats_g,
             _fused_g) = parts_multi_super_step(
                self.ts, self.evo, self.pop, self.key, self.tin, self.tout,
                self.pm, 0, self.t_max_tip, self.hyp, self.num_cells, 1,
                self._sweep_k_max, self._sweep_reform_batch,
                mesh=self.mesh, param_moves=True)
            # L: locals-only boundaries on the device half (enqueued before
            # the burst starts; the device runs it while the host works).
            # The active half sweeps with HALF the parts, so the block
            # budget scales up to deliver the full per-boundary cadence.
            n_blocks = max(1, min(MAX_BLOCKS, round(
                per_boundary / max(1.0, self._per_block_rate * n_dev
                                   / max(1, n_real)))))
            (ts_l, evo_l, pop_l, key_l, ledger_l, stats_l,
             fused_l) = parts_multi_super_step(
                ts_g, evo_g, pop_g, key_g, self.tin, self.tout, self.pm,
                n_blocks, self.t_max_tip, self.hyp, self.num_cells,
                boundaries, self._sweep_k_max, self._sweep_reform_batch,
                mesh=self.mesh, param_moves=False,
                part_sel=jnp.asarray(sel))

            _stage("dispatch G+L enqueued")
            # pull G's params (small; blocks only until G completes) and run
            # the host burst on the B half while the device runs L
            evo_h, pop_h = jax.device_get((evo_g, pop_g))
            _stage("G params pulled")
            mu, nu, q, pi = (float(evo_h.mu), np.asarray(evo_h.nu),
                             np.asarray(evo_h.q), np.asarray(evo_h.pi))
            part, q_tab = np.asarray(evo_h.part), np.asarray(evo_h.q_tab)
            if isinstance(self.pop, popm.SkygridPopParams):
                host_pop = HostSkygridPop(np.asarray(pop_h.x),
                                          np.asarray(pop_h.gamma),
                                          self.pop.type)
            else:
                host_pop = HostExpPop(pop_h.t0, pop_h.n0, pop_h.g,
                                      pop_h.min_pop)

            parts = partition_tree(tree, self._last_cuts)
            B_parts = [parts[i] for i in B]
            _stage("host parts built")
            self._topo_debt += int(self.host_rng.binomial(chunk, 2.0 / 30.0))
            budget = self._topo_debt
            self._topo_debt = 0
            dlg, acc, prop = run_bursts_on_parts(
                tree, parts, budget, host_pop, mu, nu, q, pi,
                self.host_rng, num_cells=min(self.num_cells, 400),
                parallel=self.topology_parallel_processes,
                part=part, q_tab=q_tab, do_reassemble=False,
                burst_idx=[int(i) for i in B])
            self.topology_accepted += acc
            self.topology_proposed += prop
            _stage(f"host burst ({budget} moves)")

            # join L, merge: device half from L's state, host half from the
            # burst's part trees (disjoint supports; boundary frozen on both)
            ints_h, flts_h = jax.device_get(fused_l)
            ts_h, evo_h2, pop_h2 = split_for_host(
                (ts_l, evo_l, pop_l), ints_h, flts_h)
            _stage("join L + pull fused")
            tree_m = unpack_state(ts_h, names=self.names)
            reassemble(tree_m, B_parts)
            _stage("unpack + reassemble")
            # same-site chain redraw on host-owned branches only (the device
            # may have displaced the other half's branch endpoints)
            qa_tab = -np.diagonal(q_tab, axis1=1, axis2=2)
            window = budget * 30.0 / 2.0
            rounds = max(1, round(window / max(1, cadence)))
            b_nodes = [int(g) for p in B_parts
                       for sn, g in enumerate(p.orig_index)
                       if sn != p.tree.root]
            dlg_chains = resample_multi_site_chains(
                tree_m, self.host_rng, mu, nu, part, qa_tab, rounds=rounds,
                nodes=b_nodes)
            rereference_to_root_sequence(tree_m)
            _stage("chains + rereference")

            # ledger: L's (recompute + window deltas) + burst deltas; the
            # plain log_coal is re-derived from the merged tree (the per-part
            # augmented priors do not sum to the plain prior)
            hg = HostCoalGrid(tree_m, host_pop, min(self.num_cells, 400),
                              self.t_max_tip)
            self.ledger = ledger_l._replace(
                log_G=ledger_l.log_G + dlg + dlg_chains,
                log_coal=hg.log_prior(tree_m.t))
            self.ts, self.evo, self.pop, self.key = ts_l, evo_l, pop_l, key_l
            self.last_stats = stats_l
            att = int(stats_l["local_moves_attempted"])
            self._attempted_done += att + budget
            if boundaries * n_blocks > 0 and att > 0:
                measured = att / (boundaries * n_blocks) * n_real / max(1, n_dev)
                self._per_block_rate = max(
                    1.0, 0.7 * self._per_block_rate + 0.3 * measured)

            # repack the merged tree and restencil for the next cycle
            n_muts = tree_m.num_mutations() + len(tree_m.mutations[tree_m.root])
            while n_muts > self.mut_capacity - 8:
                self.mut_capacity = _round_cap(2 * self.mut_capacity)
            n_ivs = sum(len(iv) for iv in tree_m.miss_intervals)
            while n_ivs > self.miss_capacity - 8:
                self.miss_capacity = _round_cap(2 * self.miss_capacity)
            n_fs = sum(len(fs) for fs in tree_m.miss_from_states)
            while n_fs > self.fs_capacity - 8:
                self.fs_capacity = _round_cap(2 * self.fs_capacity)
            self.ts = pack_state(tree_m, self.mut_capacity,
                                 self.miss_capacity, self.fs_capacity)
            self._fused_bundle = None
            tin, tout = tree_m.euler_positions()
            self.tin, self.tout = jnp.asarray(tin), jnp.asarray(tout)
            self._host_tree = tree_m
            self._repartition()
            self._replicate_repacked()
            self._boundaries_since_repart = 0
            _stage("pack + repartition")
            done += chunk
        self.step += n_steps

    def do_mcmc_steps(self, n_steps: int):
        """Advance n_steps local moves, interleaving global boundaries at the
        configured cadence (cf. Run::do_mcmc_steps, run.cpp:622-657).

        The device sweep performs the time/parameter moves (weights
        7.5/7.5/15 of 32); topology moves (subtree-slide + SPR1, weights
        1+1 of 32) run as host bursts at chunk boundaries — the kernels
        compose in a fixed order, preserving the stationary distribution."""
        if self._overlap_active():
            return self._do_mcmc_steps_overlapped(n_steps)
        done = 0
        cadence = self.local_moves_per_global_move
        K = self.topology_burst_chunks
        P = self.device_partitions
        # cap the device work per dispatch: a single XLA execution that runs
        # for minutes can trip device watchdogs; with lmpgm=50N this binds
        # only above ~20k tips
        import os as _os
        max_dispatch = int(_os.environ.get("DELPHY_TPU_MAX_DISPATCH_MOVES",
                                           str(32_000_000)))
        k_cap = max(1, min(K, max_dispatch // max(1, cadence)))
        if P > 1:
            # restencil granularity is bounded by dispatch size: keep
            # dispatches short enough that cut-point refresh can fire on its
            # own cadence even when topology bursts are large or disabled
            k_cap = min(k_cap, self.restencil_interval)
        while done < n_steps:
            remaining = n_steps - done
            # up to K boundaries in ONE dispatch: amortizes the per-dispatch
            # host<->device latency
            boundaries = max(1, min(k_cap, remaining // cadence))
            chunk = min(remaining, boundaries * cadence)
            per_boundary = (chunk + boundaries - 1) // boundaries
            # block budget from the MEASURED attempted-moves-per-block rate
            # (feedback, since the batched kernels' fill factor is
            # data-dependent); n_blocks is a traced arg — no recompiles
            n_blocks = max(1, min(MAX_BLOCKS,
                                  round(per_boundary / self._per_block_rate)))
            (self.ts, self.evo, self.pop, self.key, self.ledger,
             self.last_stats, self._fused_bundle) = parts_multi_super_step(
                self.ts, self.evo, self.pop, self.key, self.tin,
                self.tout, self.pm, n_blocks, self.t_max_tip, self.hyp,
                self.num_cells, boundaries, self._sweep_k_max,
                self._sweep_reform_batch, mesh=self.mesh)
            self._inflight.append((self.last_stats["local_moves_attempted"],
                                   boundaries, n_blocks))
            # opportunistic non-blocking drain; cap the in-flight queue so the
            # host can't run unboundedly ahead of the device.  Multi-host runs
            # drain BLOCKING: is_ready() is timing-dependent, and the
            # _per_block_rate feedback it gates feeds the traced n_blocks
            # argument — processes must compute identical values or their
            # trajectories diverge under the collectives.
            self._drain_inflight(block=self._multiprocess)
            while len(self._inflight) > 3:
                arr, b_, nb_ = self._inflight.pop(0)
                self._attempted_done += int(arr)
                self._per_block_rate = max(
                    1.0, 0.7 * self._per_block_rate
                    + 0.3 * int(arr) / (b_ * nb_))
            self._boundaries_since_repart += boundaries
            repartitioned = False
            if self.topology_moves_enabled:
                self._topo_debt += int(self.host_rng.binomial(chunk, 2.0 / 30.0))
                threshold = max(32, K * int(cadence * 2.0 / 30.0))
                # debt persists across do_mcmc_steps calls (the burst cadence
                # is a property of the kernel mixture, not of the caller's
                # step granularity) — but a call-end flush fires once debt
                # reaches one boundary's worth, so topology still moves in
                # any meaningful window (and micro-calls don't thrash bursts)
                flush = (done + chunk >= n_steps
                         and self._topo_debt
                         >= max(32, int(cadence * 2.0 / 30.0)))
                if self._topo_debt >= threshold or flush:
                    self._topology_burst(self._topo_debt)
                    self._attempted_done += self._topo_debt
                    self._topo_debt = 0
                    repartitioned = True
            if (not repartitioned and P > 1
                    and self._boundaries_since_repart >= self.restencil_interval):
                # periodic restencil so frozen cut-point times get resampled
                # (the reference's stencil refresh, run.cpp:87-108)
                self._repartition(sync_times=True)
            if (repartitioned
                    or self._boundaries_since_repart >= self.restencil_interval):
                self._boundaries_since_repart = 0
            done += chunk
        self.step += n_steps

    def _topology_num_parts(self) -> int:
        if self.topology_partitions > 0:
            return self.topology_partitions
        import os
        env = os.environ.get("DELPHY_TPU_TOPO_PARTS", "")
        if env:
            return max(1, int(env))
        T = self.ts.num_tips
        # more parts than workers improves load balance across the pool,
        # and at scale small parts bound the SPR study floods: on sparse
        # parsimony trees the flood roams the whole mutation-free
        # neighborhood.  Target ~200 nodes/part (T//100), capped at 1024
        # parts (scripts/topo_parts_prof.py sweeps the choice); small trees
        # keep the load-balance default.
        return max(1, min(2 * (os.cpu_count() or 1), T // 10),
                   min(1024, T // 100))

    def _topology_burst(self, n_moves: int):
        from .topo import TopologyMixer
        from .topo.mixer import HostExpPop, HostSkygridPop
        from .phylo import rereference_to_root_sequence
        import os
        import time as _time
        _verbose = os.environ.get("DELPHY_TPU_BURST_VERBOSE") == "1"
        _tl = [_time.monotonic()]

        def _stage(name):
            if not _verbose:
                return
            now = _time.monotonic()
            print(f"[burst] {name}: {now - _tl[0]:.3f}s", flush=True)
            _tl[0] = now

        # one fused device->host transfer for everything the burst needs.
        # The fused (ints, floats) bundle is an OUTPUT of the sweep dispatch
        # (parts_multi_super_step), so this is 2 pulls of ready buffers
        # instead of a fresh concat program or ~30 leaf-by-leaf fetches.
        import jax
        from .state import split_for_host, fetch_fused
        if getattr(self, "_fused_bundle", None) is not None:
            ints_h, flts_h = jax.device_get(self._fused_bundle)
            ts_h, evo_h, pop_h = split_for_host(
                (self.ts, self.evo, self.pop), ints_h, flts_h)
        else:  # no sweep dispatch since the last repack (rare)
            ts_h, evo_h, pop_h = fetch_fused((self.ts, self.evo, self.pop))
        _stage(f"device_get (n_moves={n_moves})")
        tree = unpack_state(ts_h, names=self.names)
        _stage("unpack_state")
        if isinstance(self.pop, popm.SkygridPopParams):
            host_pop = HostSkygridPop(np.asarray(pop_h.x),
                                      np.asarray(pop_h.gamma), self.pop.type)
        else:
            host_pop = HostExpPop(pop_h.t0, pop_h.n0, pop_h.g, pop_h.min_pop)
        mu, nu, q, pi = (float(evo_h.mu), np.asarray(evo_h.nu),
                         np.asarray(evo_h.q), np.asarray(evo_h.pi))
        part, q_tab = np.asarray(evo_h.part), np.asarray(evo_h.q_tab)

        import os
        P = self._topology_num_parts()
        if os.environ.get("DELPHY_TPU_TOPO_SINGLE", "0") == "1":
            P = 1
        if P > 1 and n_moves >= 16 * P:
            # partitioned phase: the very-scalable augmented prior decouples
            # parts, which run in parallel worker processes (the reference's
            # subrun fan-out, run.cpp:682-693)
            from .topo.parallel import run_partitioned_bursts
            dlg, acc, prop = run_partitioned_bursts(
                tree, n_moves, P, host_pop, mu, nu, q, pi, self.host_rng,
                num_cells=min(self.num_cells, 400),
                parallel=self.topology_parallel_processes,
                part=part, q_tab=q_tab)
            self.topology_accepted += acc
            self.topology_proposed += prop
            _stage("partitioned bursts")
            if self.ledger is not None:
                # refresh log_coal from the post-burst tree so log_posterior
                # and the stats line are not stale within the window (the
                # augmented per-part priors do not sum to the plain prior)
                from .topo.mixer import HostCoalGrid
                hg = HostCoalGrid(tree, host_pop,
                                  min(self.num_cells, 400), self.t_max_tip)
                self.ledger = self.ledger._replace(
                    log_G=self.ledger.log_G + dlg,
                    log_coal=hg.log_prior(tree.t))
                _stage("log_coal refresh")
        else:
            from .native import run_burst_native
            res = run_burst_native(
                tree, n_moves, mu, nu, q, pi, host_pop,
                seed=int(self.host_rng.integers(2 ** 63)),
                can_change_root=True, num_cells=min(self.num_cells, 400),
                t_max_tip=self.t_max_tip, part=part, q_tab=q_tab)
            if res is not None:
                dlg, dlc, acc, prop = res
            else:  # no native toolchain: Python mixer
                mixer = TopologyMixer(tree, self.host_rng,
                                      num_cells=min(self.num_cells, 400))
                mixer.run_burst(n_moves, mu, nu, q, pi, host_pop,
                                self.t_max_tip, part=part, q_tab=q_tab)
                dlg, dlc = mixer.delta_log_G, mixer.delta_log_coal
                acc, prop = mixer.n_accepted, mixer.n_proposed
            self.topology_accepted += acc
            self.topology_proposed += prop
            if self.ledger is not None:
                self.ledger = self.ledger._replace(
                    log_G=self.ledger.log_G + dlg,
                    log_coal=self.ledger.log_coal + dlc)
        # joint redraw of same-site mutation chains — the one slot class the
        # device reform can't touch (see topo/reform.py; reference redraws
        # whole branches jointly, phylo_tree.cpp:579-645)
        from .topo.reform import resample_multi_site_chains
        qa_tab = -np.diagonal(q_tab, axis1=1, axis2=2)
        # rounds scale with the local-move window this burst amortizes, so
        # chain-time mixing per move is independent of the burst cadence
        window = n_moves * 30.0 / 2.0
        rounds = max(1, round(window / max(1, self.local_moves_per_global_move)))
        dlg_chains = resample_multi_site_chains(tree, self.host_rng, mu, nu,
                                                part, qa_tab, rounds=rounds)
        if self.ledger is not None and dlg_chains != 0.0:
            self.ledger = self.ledger._replace(
                log_G=self.ledger.log_G + dlg_chains)
        _stage("multi-site chain reform")
        # keep the reference sequence anchored at the root (normalize_root,
        # run.cpp:258-275; log_G is invariant)
        rereference_to_root_sequence(tree)
        _stage("rereference")

        n_muts = tree.num_mutations() + len(tree.mutations[tree.root])
        while n_muts > self.mut_capacity - 8:
            self.mut_capacity = _round_cap(2 * self.mut_capacity)
        n_ivs = sum(len(iv) for iv in tree.miss_intervals)
        while n_ivs > self.miss_capacity - 8:
            self.miss_capacity = _round_cap(2 * self.miss_capacity)
        n_fs = sum(len(fs) for fs in tree.miss_from_states)
        while n_fs > self.fs_capacity - 8:
            self.fs_capacity = _round_cap(2 * self.fs_capacity)
        self.ts = pack_state(tree, self.mut_capacity, self.miss_capacity,
                             self.fs_capacity)
        self._fused_bundle = None
        _stage("pack_state")
        tin, tout = tree.euler_positions()
        self.tin, self.tout = jnp.asarray(tin), jnp.asarray(tout)
        # the burst changed topology and repacked the mutation pool: the
        # device partition maps must be rebuilt from the new tree
        self._host_tree = tree
        self._repartition()
        self._replicate_repacked()
        _stage("repartition")

    def _replicate_repacked(self):
        """After a host repack: the rebuilt tree state enters the mesh
        program replicated, as _place_replicated places it at init."""
        if self.mesh is not None:
            from .parallel.distributed import replicate_to_mesh
            self.ts, self.tin, self.tout = replicate_to_mesh(
                (self.ts, self.tin, self.tout), self.mesh)

    # -- observability --------------------------------------------------------

    @property
    def log_posterior(self) -> float:
        return float(self.ledger.log_posterior)

    def tree(self) -> FlatTree:
        return unpack_state(self.ts, names=self.names)

    def calc_cur_ledger(self) -> Ledger:
        """Full from-scratch recompute of the ledger under current params —
        the incremental-vs-recompute invariant used throughout the reference
        (run.cpp:316-338, subrun.cpp:28-56).  Jitted as ONE program: the
        op-by-op eager version compiles ~220 tiny XLA programs on first use,
        and paranoid mode calls this every boundary."""
        return _calc_ledger_jit(self.ts, self.evo, self.pop,
                                jnp.float64(self.t_max_tip),
                                self.num_cells, self.hyp)

    def check_derived_quantities(self, tol: float = 1e-6):
        """Debug invariant: incrementally-maintained log_G must match a full
        recompute (the reference's check at run.cpp:316-338)."""
        if self.ledger is None:
            return
        expect = self.calc_cur_ledger()
        got = float(self.ledger.log_G)
        want = float(expect.log_G)
        assert abs(got - want) < tol, f"log_G drift: {got} != {want}"

    def stats_line(self) -> str:
        led = self.ledger
        pi = np.asarray(self.evo.pi)
        if isinstance(self.pop, popm.SkygridPopParams):
            g = np.asarray(self.pop.gamma)
            pop_str = (f"Nbar {float(np.exp(g.mean())):.2f}  "
                       f"tau {float(self.pop.tau):.3f}")
        else:
            pop_str = (f"n0 {float(self.pop.n0):.2f}  "
                       f"g {float(self.pop.g)*365.0:.3f}/yr")
        return (f"step {self.step}  log_post {float(led.log_posterior):.4f}  "
                f"log_G {float(led.log_G):.4f}  log_coal {float(led.log_coal):.4f}  "
                f"muts {int(self.last_stats['num_muts'])}  "
                f"mu {float(self.evo.mu)*365.0:.3e}/yr  "
                + (f"mu* {float(self.evo.mu * self.evo.mpox_rho)*365.0:.3e}/yr  "
                   if self.mpox_hack else "")
                + f"kappa {float(self.evo.kappa):.3f}  "
                f"pi [{pi[0]:.2f} {pi[1]:.2f} {pi[2]:.2f} {pi[3]:.2f}]  "
                f"{pop_str}  "
                f"t_root {float(self.ts.t[self.ts.root]):.2f}")
