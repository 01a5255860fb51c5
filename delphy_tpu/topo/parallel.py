"""Process-parallel partitioned topology phase.

The statistical decoupling (partition.py + vsc.py) makes per-part topology
bursts independent, so they farm onto worker processes — the host-side
counterpart of the reference's ctpl thread pool fan-out (run.cpp:682-693).
Workers are pure numpy/scipy consumers of picklable part payloads; a
persistent spawn-pool amortizes interpreter startup."""

from __future__ import annotations

import atexit
import multiprocessing as mp
import os

import numpy as np

_POOL = None


def _pool_usable() -> bool:
    """Spawned workers re-import __main__; interactive/stdin parents can't be
    re-imported, so fall back to serial execution there."""
    import sys
    main = sys.modules.get("__main__")
    f = getattr(main, "__file__", None)
    return bool(f) and os.path.exists(f)


def _get_pool(n_workers: int):
    """Spawn pool whose workers never open the accelerator: they start with
    JAX_PLATFORMS=cpu in their environment (one process per card)."""
    global _POOL
    if _POOL is None or _POOL._processes < n_workers:
        if _POOL is not None:
            _POOL.terminate()
        ctx = mp.get_context("spawn")
        keys = ("JAX_PLATFORMS", "DELPHY_TPU_FORCE_CPU")
        saved = {k: os.environ.get(k) for k in keys}
        os.environ.update(JAX_PLATFORMS="cpu", DELPHY_TPU_FORCE_CPU="1")
        try:
            _POOL = ctx.Pool(processes=n_workers)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        atexit.register(_POOL.terminate)
    return _POOL


def run_part_burst(payload):
    """Worker: run one part's topology burst; returns the mutated part tree
    and ledger deltas."""
    (part_tree, vsc, n_moves, can_change_root, mu, nu, q, pi, seed,
     sp, q_tab) = payload
    from .mixer import TopologyMixer

    rng = np.random.default_rng(seed)
    T = part_tree.num_tips
    t_max_tip = float(np.max(part_tree.t_max[:T]))
    mixer = TopologyMixer(part_tree, rng, can_change_root=can_change_root)
    mixer.run_burst(n_moves, mu, nu, q, pi, None, t_max_tip, coal=vsc,
                    part=sp, q_tab=q_tab)
    return (part_tree, mixer.delta_log_G, mixer.n_accepted, mixer.n_proposed)


def run_partitioned_bursts(tree, n_moves: int, num_parts: int, host_pop,
                           mu, nu, q, pi, host_rng, num_cells: int = 400,
                           parallel: bool = True, part=None, q_tab=None):
    """Partition -> per-part bursts (optionally in parallel processes) ->
    reassemble.  Returns (delta_log_G, n_accepted, n_proposed)."""
    from ..phylo import rereference_to_root_sequence
    from .partition import generate_random_partition_stencil, partition_tree

    rereference_to_root_sequence(tree)
    stencil = generate_random_partition_stencil(tree, num_parts, host_rng)
    parts = partition_tree(tree, stencil)
    return run_bursts_on_parts(tree, parts, n_moves, host_pop, mu, nu, q, pi,
                               host_rng, num_cells=num_cells,
                               parallel=parallel, part=part, q_tab=q_tab)


def run_bursts_on_parts(tree, parts, n_moves: int, host_pop,
                        mu, nu, q, pi, host_rng, num_cells: int = 400,
                        parallel: bool = True, part=None, q_tab=None,
                        do_reassemble: bool = True, burst_idx=None):
    """Per-part bursts on EXPLICIT pre-built parts (the overlapped driver
    hands the device-stencil's parts here), then reassemble into `tree`.
    Returns (delta_log_G, n_accepted, n_proposed).

    burst_idx: optional indices of the parts that actually receive moves.
    The augmented priors are ALWAYS built over the full `parts` list (the
    auxiliary fields condition on the total lineage staircase; unburst
    parts' contributions stay frozen, very_scalable_coalescent.cpp:85-232).

    do_reassemble=False leaves the mutated part trees un-merged: the
    overlapped driver reassembles them into the POST-device-phase tree
    instead of the snapshot the parts were cut from (disjoint supports make
    that exact)."""
    from .partition import reassemble
    from .vsc import make_vsc_parts

    rngs = [np.random.default_rng(host_rng.integers(2 ** 63)) for _ in parts]

    t_root = float(tree.t[tree.root])
    t_max = float(np.max(tree.t_max[:tree.num_tips]))
    t_step = max((t_max - t_root), 1.0) * 1.35 / num_cells
    vscs = make_vsc_parts(parts, host_pop, rngs, t_step)

    if burst_idx is None:
        burst_idx = range(len(parts))
    chosen = [(parts[i], vscs[i], rngs[i]) for i in burst_idx]
    sizes = np.array([p.tree.num_nodes for p, _, _ in chosen],
                     dtype=np.float64)
    alloc = host_rng.multinomial(n_moves, sizes / sizes.sum())

    payloads = []
    for (p, vsc, prng), k in zip(chosen, alloc):
        if k == 0 or p.tree.num_nodes < 5:
            continue
        payloads.append((p, vsc, int(k), int(prng.integers(2 ** 63))))

    delta_log_G, n_acc, n_prop = 0.0, 0, 0

    # preferred path: the native kernel releases the GIL, so per-part bursts
    # run on a plain thread pool — no pickling, no worker processes (the
    # reference's ctpl thread-pool architecture, run.cpp:682-693)
    from ..native import native_available, run_burst_native
    if native_available():
        def _native_one(args):
            p, vsc, k, seed = args
            tmx = float(np.max(p.tree.t_max[:p.tree.num_tips]))
            return run_burst_native(p.tree, k, mu, nu, q, pi, host_pop,
                                    seed=seed, can_change_root=p.includes_root,
                                    t_max_tip=tmx, vsc=vsc,
                                    part=part, q_tab=q_tab)
        from concurrent.futures import ThreadPoolExecutor
        if parallel and len(payloads) > 1:
            with ThreadPoolExecutor(min(len(payloads),
                                        os.cpu_count() or 4)) as ex:
                results = list(ex.map(_native_one, payloads))
        else:
            results = [_native_one(pl) for pl in payloads]
        # a failed part leaves its tree untouched (the kernel mutates only on
        # success), so partial failures just mean fewer moves this burst
        for r in results:
            if r is not None:
                dlg, _dlc, acc, prop = r
                delta_log_G += dlg
                n_acc += acc
                n_prop += prop
        if do_reassemble:
            reassemble(tree, parts)
        return delta_log_G, n_acc, n_prop

    py_payloads = [(p, (p.tree, vsc, k, p.includes_root, mu, nu, q, pi, seed,
                        part, q_tab))
                   for (p, vsc, k, seed) in payloads]
    if parallel and len(py_payloads) > 1 and _pool_usable():
        try:
            pool = _get_pool(min(len(py_payloads), os.cpu_count() or 4))
            results = pool.map(run_part_burst, [pl for (_, pl) in py_payloads])
        except Exception:
            results = [run_part_burst(pl) for (_, pl) in py_payloads]
    else:
        results = [run_part_burst(pl) for (_, pl) in py_payloads]

    for (p, _), (new_tree, dlg, acc, prop) in zip(py_payloads, results):
        p.tree = new_tree  # workers return a copy (pickled round trip)
        delta_log_G += dlg
        n_acc += acc
        n_prop += prop

    if do_reassemble:
        reassemble(tree, parts)
    return delta_log_G, n_acc, n_prop
