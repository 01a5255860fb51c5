"""Attribute eager-op XLA compiles to Python call sites.

Cold time-to-first-sample can be dominated by many tiny op-by-op compiles
rather than the big sweep programs.  This script runs the bench
construction + warmup path on the CPU backend (same op set, ms compiles)
with the persistent cache off and a logging hook that records the user-code
stack frame for every compile log record, then prints the top offending
call sites.
"""

import collections
import logging
import os
import sys
import traceback

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax  # noqa: E402

import delphy_tpu  # noqa: E402,F401  (x64; sets the cache dir, undone below)

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_compilation_cache", False)  # count every one
jax.config.update("jax_log_compiles", True)

SITES = collections.Counter()
NAMES = collections.defaultdict(collections.Counter)


class Hook(logging.Handler):
    def emit(self, record):
        msg = record.getMessage()
        if "Finished XLA compilation" not in msg:
            return
        name = msg.split("Finished XLA compilation of ", 1)[-1].split(" in ")[0]
        site = "?"
        for fr in reversed(traceback.extract_stack()):
            f = fr.filename
            if f.endswith("compile_sites.py"):
                continue
            if "/delphy_tpu/" in f or f.endswith("bench.py"):
                site = f"{f.rsplit('/', 1)[-1]}:{fr.lineno}"
                break
        SITES[site] += 1
        NAMES[site][name] += 1


for lg in ("jax._src.dispatch", "jax._src.interpreters.pxla", "jax"):
    logging.getLogger(lg).addHandler(Hook())
    logging.getLogger(lg).setLevel(logging.DEBUG)


def main():
    import numpy as np
    from delphy_tpu.io.maple import read_maple
    from delphy_tpu.init_tree import build_initial_tree
    from delphy_tpu.run import Run

    mf = read_maple(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "data", "ebola2014_like_81x18959.maple"))
    tips = mf.tips
    tree = build_initial_tree(mf.ref_seq, [t.deltas for t in tips],
                              [t.miss_intervals for t in tips],
                              [(t.t_min, t.t_max) for t in tips],
                              names=[t.name for t in tips],
                              rng=np.random.default_rng(42))
    run = Run(tree, seed=1, num_cells=400)
    print(f"--- after Run(): {sum(SITES.values())} compiles", flush=True)
    run.do_mcmc_steps(10)
    print(f"--- after 1-boundary: {sum(SITES.values())} compiles", flush=True)
    run.do_mcmc_steps(run.local_moves_per_global_move
                      * run.topology_burst_chunks)
    print(f"--- after multi-boundary: {sum(SITES.values())} compiles",
          flush=True)
    print()
    for site, n in SITES.most_common(40):
        ops = ", ".join(f"{k}x{v}" for k, v in NAMES[site].most_common(6))
        print(f"{n:5d}  {site:40s} {ops}")


if __name__ == "__main__":
    main()
