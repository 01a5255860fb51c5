"""Command-line interface mirroring the reference's unstable --v0-* flag set
(core/cmdline.cpp:164-381; the subset implemented so far).

Main loop structure follows tools/delphy.cpp:128-219: interleave
do_mcmc_steps with a stats line, BEAST-format .log/.trees output at their
cadences.
"""

from __future__ import annotations

import argparse
import math
import sys
import time
from collections import deque

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="delphy-tpu",
        description="Accelerator-native Bayesian phylogenetics via Explicit Mutation-Annotated Trees")
    p.add_argument("--version", action="store_true")
    a = p.add_argument
    a("--v0-in-fasta", metavar="FILE")
    a("--v0-in-maple", metavar="FILE")
    a("--v0-steps", type=int, default=-1, help="default: 100,000 per tip")
    a("--v0-seed", type=int, default=0)
    a("--v0-threads", type=int, default=0,
      help="host threads for topology bursts (0 = all cores, the reference "
           "default); device parallelism is governed by the mesh")
    a("--mesh-devices", type=int, default=-1, metavar="N",
      help="accelerator devices for the tree-partition mesh: -1 (default) "
           "uses all visible devices (shard_map over a ('part',) mesh when "
           ">1, the analogue of the reference's thread fan-out, "
           "run.cpp:622-693); 1 forces the single-device vmap path")
    a("--v0-paranoid", action="store_true")
    a("--v0-out-log-file", metavar="FILE")
    a("--v0-log-every", type=int, default=-1)
    a("--v0-out-trees-file", metavar="FILE")
    a("--v0-tree-every", type=int, default=-1)
    a("--v0-site-rate-heterogeneity", action="store_true")
    a("--v0-mpox-hack", action="store_true")
    a("--v0-init-mutation-rate", type=float, default=None)
    a("--v0-fix-mutation-rate", action="store_true")
    a("--v0-mu-prior-mean", type=float, default=None)
    a("--v0-mu-prior-stddev", type=float, default=None)
    a("--v0-mu-prior-alpha", type=float, default=None)
    a("--v0-mu-prior-beta", type=float, default=None)
    a("--v0-pop-model", choices=["exp", "skygrid"], default="exp")
    a("--v0-init-final-pop-size", type=float, default=None)
    a("--v0-fix-final-pop-size", action="store_true")
    a("--v0-init-pop-growth-rate", type=float, default=None)
    a("--v0-fix-pop-growth-rate", action="store_true")
    a("--v0-pop-growth-rate-min", type=float, default=-math.inf)
    a("--v0-pop-growth-rate-max", type=float, default=math.inf)
    a("--v0-pop-min-pop", type=float, default=None)
    a("--v0-pop-g-prior-mu", type=float, default=None)
    a("--v0-pop-g-prior-scale", type=float, default=None)
    a("--v0-pop-g-prior-exponential-with-mean", type=float, default=None,
      help="Exponential prior on g with given mean (years^-1); sign sets the"
           " allowed half-line (cmdline.cpp:846-875)")
    a("--v0-pop-inv-n0-prior-alpha", type=float, default=None)
    a("--v0-pop-inv-n0-prior-beta", type=float, default=None,
      help="InverseGamma(alpha, beta) prior on n0 (beta in years)")
    a("--v0-pop-n0-prior-mean", type=float, default=None)
    a("--v0-pop-n0-prior-stddev", type=float, default=None,
      help="lognormal-ish convenience: converted to InverseGamma via "
           "alpha = 2 + (mean/stddev)^2, beta = mean*(alpha-1) "
           "(cmdline.cpp:795-819)")
    a("--v0-target-coal-prior-cells", type=int, default=400)
    a("--v0-init", choices=["random", "greedy", "mp-plus-timing",
                            "old-usher-like"],
      default=None,
      help="'greedy'/'old-usher-like': nearest-neighbour parsimony guide tree;"
           " 'mp-plus-timing' (default): guide tree + Fitch factoring + OLS"
           " rooting; 'random': random coalescent topology")
    a("--v0-init-heuristic", action="store_true",
      help="[deprecated, use --v0-init old-usher-like]")
    a("--v0-init-random", action="store_true",
      help="[deprecated, use --v0-init random]")
    a("--v0-skygrid-type", choices=["staircase", "log-linear"], default="staircase")
    a("--v0-skygrid-num-parameters", type=int, default=50)
    a("--v0-skygrid-cutoff", type=float, default=0.0,
      help="years before last tip for the final transition (0 = auto)")
    a("--v0-skygrid-first-knot-date", default=None,
      help="ISO date of the oldest knot x_0; with --v0-skygrid-last-knot-date,"
           " mutually exclusive with --v0-skygrid-cutoff")
    a("--v0-skygrid-last-knot-date", default=None)
    a("--v0-skygrid-infer-prior-smoothness", action="store_true",
      help="infer tau under Gamma(alpha,beta) hyperprior (BEAST default) "
           "instead of fixing it (Delphy default)")
    a("--v0-skygrid-prior-double-half-time", type=float, default=None,
      help="years over which the prior population curve fluctuates 2x "
           "(default 30/365); fixes tau = 1/(2 D dt), D = log^2(2)/(2 T) "
           "(cmdline.cpp:1026-1045)")
    a("--v0-skygrid-tau", type=float, default=None)
    a("--v0-skygrid-tau-prior-alpha", type=float, default=0.001)
    a("--v0-skygrid-tau-prior-beta", type=float, default=0.001)
    a("--v0-skygrid-disable-low-pop-barrier", action="store_true")
    a("--v0-skygrid-low-pop-barrier-loc", type=float, default=1.0 / 365.0,
      help="minimum N(t) in years below which the barrier penalizes")
    a("--v0-skygrid-low-pop-barrier-scale", type=float, default=0.30)
    a("--v0-skygrid-inv-nbar-prior-alpha", type=float, default=None)
    a("--v0-skygrid-inv-nbar-prior-beta", type=float, default=None,
      help="InverseGamma prior on N_bar (beta in years)")
    a("--v0-skygrid-nbar-prior-mean", type=float, default=None)
    a("--v0-skygrid-nbar-prior-stddev", type=float, default=None,
      help="converted to InverseGamma as for --v0-pop-n0-prior-mean/stddev")
    a("--v0-out-delphy-metadata-file", metavar="FILE",
      help="JSON metadata blob to append to the .dphy epilog")
    a("--v0-out-delphy-file", metavar="FILE",
      help="run snapshot (npz save/resume; functional .dphy counterpart)")
    a("--v0-delphy-snapshot-every", type=int, default=-1)
    a("--v0-out-beast-version", default="2.6.2",
      choices=["2.6.2", "2.7.7", "X-10.5.0"])
    a("--v0-out-beast-xml", metavar="FILE",
      help="export an equivalent BEAST2 XML config and exit")
    a("--v0-out-mcc-file", metavar="FILE",
      help="MCC tree (NEXUS) derived from sampled trees at --v0-tree-every")
    return p


def truncated_laplace_mean(mu: float, s: float, a: float, b: float) -> float:
    """Mean of a Laplace(mu, s) truncated to [a, b] (cmdline.cpp:125-157)."""
    assert s > 0.0 and a <= mu <= b
    p = (mu - a) / s
    q = (b - mu) / s
    if math.isinf(p) and math.isinf(q):
        return mu
    if math.isinf(p):                       # only upper bound
        eq = math.exp(-q)
        return mu + (s / 2) * (-(q + 1) * eq) / (1 - eq / 2)
    if math.isinf(q):                       # only lower bound
        ep = math.exp(-p)
        return mu + (s / 2) * ((p + 1) * ep) / (1 - ep / 2)
    if p + q < 1e-4:                        # Taylor fallback for tight bounds
        return (a + b) / 2
    ep, eq = math.exp(-p), math.exp(-q)
    return mu + (s / 2) * ((1 + p) * ep - (1 + q) * eq) / (1 - (ep + eq) / 2)


class _CliError(Exception):
    pass


def main(argv=None) -> int:
    # multi-host: rendezvous BEFORE any backend use, so jax.devices() is the
    # global list and --mesh-devices spans hosts (parallel/distributed.py)
    from .parallel.distributed import initialize_from_env
    initialize_from_env()
    args = build_parser().parse_args(argv)
    try:
        return _main(args)
    except _CliError as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1


def _main(args) -> int:

    if args.version:
        from .version import __version__
        print(f"delphy-tpu {__version__}")
        return 0

    from .io.maple import read_maple
    from .io.fasta import read_fasta, deduce_consensus, fasta_to_tips
    from .io.beast_out import BeastLogOutput, BeastTreesOutput
    from .phylo import build_random_tree
    from .run import Run
    from .mcmc.global_moves import PriorConfig

    warn = lambda msg: print(f"WARNING: {msg}", file=sys.stderr)

    if args.v0_in_maple:
        mf = read_maple(args.v0_in_maple, warn=warn)
        ref_seq, tips = mf.ref_seq, mf.tips
    elif args.v0_in_fasta:
        records = read_fasta(args.v0_in_fasta)
        if not records:
            print("ERROR: empty FASTA", file=sys.stderr)
            return 1
        length = max(len(r.bits) for r in records)
        ref_seq = deduce_consensus(records, length)
        tips = fasta_to_tips(records, ref_seq, warn=warn)
    else:
        print("ERROR: provide --v0-in-fasta or --v0-in-maple", file=sys.stderr)
        return 1

    if len(tips) < 2:
        print("ERROR: need at least 2 usable tips", file=sys.stderr)
        return 1
    print(f"Read {len(tips)} tips, {len(ref_seq)} sites", file=sys.stderr)

    # init-method selection incl. deprecated aliases (cmdline.cpp:427-457)
    n_init_opts = ((1 if args.v0_init is not None else 0)
                   + (1 if args.v0_init_heuristic else 0)
                   + (1 if args.v0_init_random else 0))
    if n_init_opts > 1:
        raise _CliError("The options --v0-init, --v0-init-heuristic, and "
                        "--v0-init-random are mutually exclusive.  Pick one.")
    init_method = args.v0_init or "mp-plus-timing"
    if args.v0_init_random:
        init_method = "random"
    elif args.v0_init_heuristic:
        init_method = "old-usher-like"

    rng = np.random.default_rng(args.v0_seed)
    if init_method == "random":
        builder = build_random_tree
    elif init_method in ("greedy", "old-usher-like"):
        from .phylo import build_greedy_tree as builder
    else:  # mp-plus-timing: guide tree + Fitch factoring + OLS rooting
        from .init_tree import build_initial_tree as builder
    tree = builder(
        ref_seq,
        [t.deltas for t in tips],
        [t.miss_intervals for t in tips],
        [(t.t_min, t.t_max) for t in tips],
        names=[t.name for t in tips],
        rng=rng)

    # prior conveniences (cmdline.cpp:125-157): mean/stddev -> Gamma alpha/beta
    hyp_kwargs = {}
    if args.v0_mu_prior_mean is not None and args.v0_mu_prior_stddev is not None:
        m, s = args.v0_mu_prior_mean / 365.0, args.v0_mu_prior_stddev / 365.0
        hyp_kwargs["mu_prior_alpha"] = (m / s) ** 2
        hyp_kwargs["mu_prior_beta"] = m / (s * s)
    if args.v0_mu_prior_alpha is not None:
        hyp_kwargs["mu_prior_alpha"] = args.v0_mu_prior_alpha
    if args.v0_mu_prior_beta is not None:
        hyp_kwargs["mu_prior_beta"] = args.v0_mu_prior_beta

    # ---- exponential pop model priors (cmdline.cpp:780-920) ---------------
    is_skygrid = args.v0_pop_model == "skygrid"
    has_exp_params = (
        args.v0_init_final_pop_size is not None
        or args.v0_init_pop_growth_rate is not None
        or args.v0_pop_min_pop is not None
        or args.v0_pop_g_prior_mu is not None
        or args.v0_pop_g_prior_scale is not None
        or args.v0_pop_g_prior_exponential_with_mean is not None
        or args.v0_pop_inv_n0_prior_alpha is not None
        or args.v0_pop_inv_n0_prior_beta is not None
        or args.v0_pop_n0_prior_mean is not None
        or args.v0_pop_n0_prior_stddev is not None
        or math.isfinite(args.v0_pop_growth_rate_min)
        or math.isfinite(args.v0_pop_growth_rate_max))
    if is_skygrid and has_exp_params:
        raise _CliError("Cannot specify parameters for 'exponential' model "
                        "when pop-model is 'skygrid'")

    init_n0_days = None
    init_g_per_day = None

    # InverseGamma prior on n0 (CLI beta in years -> days internally)
    has_inv_n0 = (args.v0_pop_inv_n0_prior_alpha is not None
                  or args.v0_pop_inv_n0_prior_beta is not None)
    has_n0_ms = (args.v0_pop_n0_prior_mean is not None
                 or args.v0_pop_n0_prior_stddev is not None)
    if has_inv_n0 and has_n0_ms:
        raise _CliError("--v0-pop-inv-n0-prior-alpha/beta and "
                        "--v0-pop-n0-prior-mean/stddev are mutually exclusive")
    if has_n0_ms:
        if args.v0_pop_n0_prior_mean is None or args.v0_pop_n0_prior_stddev is None:
            raise _CliError("--v0-pop-n0-prior-mean and --v0-pop-n0-prior-stddev"
                            " must be specified together")
        m, s = args.v0_pop_n0_prior_mean, args.v0_pop_n0_prior_stddev
        if m <= 0.0 or s <= 0.0:
            raise _CliError("--v0-pop-n0-prior-mean/stddev must be positive")
        al = 2.0 + (m / s) ** 2
        hyp_kwargs["pop_inv_n0_prior_alpha"] = al
        hyp_kwargs["pop_inv_n0_prior_beta"] = m * (al - 1.0) * 365.0
        init_n0_days = m * 365.0
    elif has_inv_n0:
        al = args.v0_pop_inv_n0_prior_alpha or 0.0
        be = args.v0_pop_inv_n0_prior_beta or 0.0
        if al < 0.0 or be < 0.0:
            raise _CliError("--v0-pop-inv-n0-prior-alpha/beta must be non-negative")
        hyp_kwargs["pop_inv_n0_prior_alpha"] = al
        hyp_kwargs["pop_inv_n0_prior_beta"] = be * 365.0
        if al > 1.0 and be > 0.0:
            init_n0_days = be / (al - 1.0) * 365.0

    # Laplace prior on g, with optional bounds / exponential variant
    has_g_direct = (args.v0_pop_g_prior_mu is not None
                    or args.v0_pop_g_prior_scale is not None
                    or math.isfinite(args.v0_pop_growth_rate_min)
                    or math.isfinite(args.v0_pop_growth_rate_max))
    has_g_exp = args.v0_pop_g_prior_exponential_with_mean is not None
    if has_g_direct and has_g_exp:
        raise _CliError("--v0-pop-g-prior-exponential-with-mean is mutually "
                        "exclusive with --v0-pop-g-prior-mu, "
                        "--v0-pop-g-prior-scale, --v0-pop-growth-rate-min, "
                        "and --v0-pop-growth-rate-max")
    pop_g_min = -math.inf
    pop_g_max = math.inf
    if has_g_exp:
        exp_mean = args.v0_pop_g_prior_exponential_with_mean
        if exp_mean == 0.0:
            raise _CliError("--v0-pop-g-prior-exponential-with-mean must be nonzero")
        hyp_kwargs["pop_g_prior_mu"] = 0.0
        hyp_kwargs["pop_g_prior_scale"] = abs(exp_mean) / 365.0
        if exp_mean > 0.0:
            pop_g_min = 0.0
        else:
            pop_g_max = 0.0
    else:
        if args.v0_pop_g_prior_mu is not None:
            hyp_kwargs["pop_g_prior_mu"] = args.v0_pop_g_prior_mu / 365.0
        if args.v0_pop_g_prior_scale is not None:
            hyp_kwargs["pop_g_prior_scale"] = args.v0_pop_g_prior_scale / 365.0
        if math.isfinite(args.v0_pop_growth_rate_min):
            pop_g_min = args.v0_pop_growth_rate_min / 365.0
        if math.isfinite(args.v0_pop_growth_rate_max):
            pop_g_max = args.v0_pop_growth_rate_max / 365.0
    if pop_g_min > pop_g_max:
        raise _CliError("--v0-pop-growth-rate-min must be <= --v0-pop-growth-rate-max")
    # init g at the truncated-prior mean when only prior flags were given
    if (has_g_direct or has_g_exp) and args.v0_init_pop_growth_rate is None:
        from .mcmc.global_moves import PriorConfig as _PC
        g_mu = hyp_kwargs.get("pop_g_prior_mu", _PC.pop_g_prior_mu)
        g_s = hyp_kwargs.get("pop_g_prior_scale", _PC.pop_g_prior_scale)
        init_g_per_day = truncated_laplace_mean(g_mu, g_s, pop_g_min, pop_g_max)

    # ---- skygrid configuration (cmdline.cpp:922-1160) ---------------------
    run_kwargs = {}
    if is_skygrid:
        from .dates import parse_iso_date
        has_first = args.v0_skygrid_first_knot_date is not None
        has_last = args.v0_skygrid_last_knot_date is not None
        if has_first != has_last:
            raise _CliError("--v0-skygrid-first-knot-date and "
                            "--v0-skygrid-last-knot-date must be specified together")
        if has_first and args.v0_skygrid_cutoff > 0:
            raise _CliError("--v0-skygrid-first-knot-date / "
                            "--v0-skygrid-last-knot-date and --v0-skygrid-cutoff"
                            " are mutually exclusive")
        if has_first:
            run_kwargs["skygrid_x0_days"] = parse_iso_date(
                args.v0_skygrid_first_knot_date)
            run_kwargs["skygrid_xM_days"] = parse_iso_date(
                args.v0_skygrid_last_knot_date)

        if args.v0_skygrid_infer_prior_smoothness:
            al = args.v0_skygrid_tau_prior_alpha
            be = args.v0_skygrid_tau_prior_beta
            if al <= 0.0 or be <= 0.0:
                raise _CliError("Skygrid tau prior parameters must be positive")
            run_kwargs["skygrid_tau"] = al / be
            hyp_kwargs["skygrid_tau_move_enabled"] = True
        else:
            if (args.v0_skygrid_tau is not None
                    and args.v0_skygrid_prior_double_half_time is not None):
                raise _CliError("Skygrid tau can be fixed either directly "
                                "(--v0-skygrid-tau) or via "
                                "--v0-skygrid-prior-double-half-time, not both")
            if args.v0_skygrid_tau is not None:
                if args.v0_skygrid_tau <= 0.0:
                    raise _CliError("Skygrid tau parameter must be positive")
                run_kwargs["skygrid_tau"] = args.v0_skygrid_tau
            else:
                dht = (args.v0_skygrid_prior_double_half_time
                       if args.v0_skygrid_prior_double_half_time is not None
                       else 30.0 / 365.0)
                if dht <= 0.0:
                    raise _CliError("Skygrid prior 'double-half' time must be positive")
                run_kwargs["skygrid_double_half_time_days"] = dht * 365.0
            hyp_kwargs["skygrid_tau_move_enabled"] = False

        # InverseGamma prior on N_bar (CLI beta in years -> days internally)
        has_inv_nbar = (args.v0_skygrid_inv_nbar_prior_alpha is not None
                        or args.v0_skygrid_inv_nbar_prior_beta is not None)
        has_nbar_ms = (args.v0_skygrid_nbar_prior_mean is not None
                       or args.v0_skygrid_nbar_prior_stddev is not None)
        if has_inv_nbar and has_nbar_ms:
            raise _CliError("--v0-skygrid-inv-nbar-prior-alpha/beta and "
                            "--v0-skygrid-nbar-prior-mean/stddev are "
                            "mutually exclusive")
        if has_nbar_ms:
            if (args.v0_skygrid_nbar_prior_mean is None
                    or args.v0_skygrid_nbar_prior_stddev is None):
                raise _CliError("--v0-skygrid-nbar-prior-mean and "
                                "--v0-skygrid-nbar-prior-stddev must be "
                                "specified together")
            m, s = args.v0_skygrid_nbar_prior_mean, args.v0_skygrid_nbar_prior_stddev
            if m <= 0.0 or s <= 0.0:
                raise _CliError("--v0-skygrid-nbar-prior-mean/stddev must be positive")
            al = 2.0 + (m / s) ** 2
            hyp_kwargs["skygrid_inv_nbar_prior_alpha"] = al
            hyp_kwargs["skygrid_inv_nbar_prior_beta"] = m * (al - 1.0) * 365.0
            run_kwargs["skygrid_init_nbar_days"] = m * 365.0
        elif has_inv_nbar:
            al = args.v0_skygrid_inv_nbar_prior_alpha or 0.0
            be = args.v0_skygrid_inv_nbar_prior_beta or 0.0
            if al < 0.0 or be < 0.0:
                raise _CliError("--v0-skygrid-inv-nbar-prior-alpha/beta must "
                                "be non-negative")
            hyp_kwargs["skygrid_inv_nbar_prior_alpha"] = al
            hyp_kwargs["skygrid_inv_nbar_prior_beta"] = be * 365.0
            if al > 1.0 and be > 0.0:
                run_kwargs["skygrid_init_nbar_days"] = be / (al - 1.0) * 365.0

        # low-pop barrier: CLI loc in years of N(t) -> loc in gamma = log N;
        # scale fraction -> gamma scale (cmdline.cpp:1129-1145)
        if not args.v0_skygrid_disable_low_pop_barrier:
            loc_days = args.v0_skygrid_low_pop_barrier_loc * 365.0
            if loc_days <= 0.0:
                raise _CliError("--v0-skygrid-low-pop-barrier-loc must be positive")
            frac = args.v0_skygrid_low_pop_barrier_scale
            if not (0.0 < frac < 1.0):
                raise _CliError("--v0-skygrid-low-pop-barrier-scale must be in (0, 1)")
            hyp_kwargs["skygrid_low_gamma_barrier_loc"] = math.log(loc_days)
            hyp_kwargs["skygrid_low_gamma_barrier_scale"] = -math.log(1.0 - frac)

    hyp = PriorConfig(
        alpha_move_enabled=args.v0_site_rate_heterogeneity,
        mu_fixed=args.v0_fix_mutation_rate,
        pop_size_move_enabled=not args.v0_fix_final_pop_size,
        pop_growth_rate_move_enabled=not args.v0_fix_pop_growth_rate,
        pop_g_min=pop_g_min,
        pop_g_max=pop_g_max,
        skygrid_tau_prior_alpha=args.v0_skygrid_tau_prior_alpha,
        skygrid_tau_prior_beta=args.v0_skygrid_tau_prior_beta,
        skygrid_low_gamma_barrier_enabled=not args.v0_skygrid_disable_low_pop_barrier,
        **hyp_kwargs)

    from delphy_tpu import pop as popm
    # --v0-threads governs host-side topology-burst parallelism, the
    # analogue of the reference's ctpl pool sizing (cmdline.cpp:408-418:
    # partitions default to thread count; more parts than workers improves
    # pool balance, hence 2x)
    if args.v0_threads and args.v0_threads > 0:
        run_kwargs.setdefault("topology_partitions", 2 * args.v0_threads)
    # multi-device: partitioned sweeps run under shard_map across a
    # ("part",) mesh with psum reassembly (reference: run.cpp:622-693)
    import jax
    n_mesh = args.mesh_devices
    if n_mesh < 0:
        n_mesh = len(jax.devices())
    if n_mesh > 1:
        from jax.sharding import Mesh
        devs = jax.devices()
        if n_mesh > len(devs):
            raise _CliError(f"--mesh-devices {n_mesh}: only {len(devs)} "
                            "devices visible")
        run_kwargs["mesh"] = Mesh(np.array(devs[:n_mesh]), axis_names=("part",))
        print(f"Sharding partitioned sweeps over {n_mesh} devices",
              file=sys.stderr)
    run = Run(tree, seed=args.v0_seed, hyp=hyp,
              mpox_hack=args.v0_mpox_hack,
              num_cells=max(64, args.v0_target_coal_prior_cells),
              pop_model=args.v0_pop_model,
              skygrid_num_parameters=args.v0_skygrid_num_parameters,
              skygrid_cutoff_days=(args.v0_skygrid_cutoff * 365.0
                                   if args.v0_skygrid_cutoff > 0 else None),
              skygrid_type=(popm.STAIRCASE if args.v0_skygrid_type == "staircase"
                            else popm.LOG_LINEAR),
              **run_kwargs)
    if args.v0_init_mutation_rate is not None:
        run.set_mu(args.v0_init_mutation_rate / 365.0)
    if not is_skygrid:
        if args.v0_init_final_pop_size is not None:
            run.set_pop(n0=args.v0_init_final_pop_size * 365.0)
        elif init_n0_days is not None:
            run.set_pop(n0=init_n0_days)
        if args.v0_init_pop_growth_rate is not None:
            run.set_pop(g=args.v0_init_pop_growth_rate / 365.0)
        elif init_g_per_day is not None:
            run.set_pop(g=init_g_per_day)
        if args.v0_pop_min_pop is not None:
            run.set_pop(min_pop=args.v0_pop_min_pop * 365.0)

    if args.v0_out_beast_xml:
        from .io.beast_xml import (export_beast2_xml, export_beast2_7_xml,
                                   export_beast_x_xml)
        with open(args.v0_out_beast_xml, "w") as f:
            if args.v0_out_beast_version == "X-10.5.0":
                export_beast_x_xml(f, run.tree(), run)
            elif args.v0_out_beast_version == "2.7.7":
                export_beast2_7_xml(f, run.tree(), run)
            else:
                export_beast2_xml(f, run.tree(), run)
        print(f"Wrote BEAST {args.v0_out_beast_version} XML to "
              f"{args.v0_out_beast_xml}", file=sys.stderr)
        return 0

    steps = args.v0_steps if args.v0_steps > 0 else 100_000 * len(tips)
    log_every = args.v0_log_every if args.v0_log_every > 0 else max(steps // 100, 1)
    tree_every = args.v0_tree_every if args.v0_tree_every > 0 else max(steps // 100, 1)
    snap_every = (args.v0_delphy_snapshot_every if args.v0_delphy_snapshot_every > 0
                  else max(steps // 10, 1))

    log_out = trees_out = dphy_out = None
    if args.v0_out_log_file:
        log_out = BeastLogOutput(open(args.v0_out_log_file, "w"),
                                 mu_move_enabled=not args.v0_fix_mutation_rate,
                                 alpha_move_enabled=args.v0_site_rate_heterogeneity)
        log_out.write_headers(tree)
    if args.v0_out_delphy_file and args.v0_out_delphy_file.endswith(".dphy"):
        # reference-compatible binary stream (tools/delphy.cpp:188-194);
        # any other extension keeps the engine's own npz save/resume format
        from .io.dphy import DphyOutput
        dphy_kwargs = {}
        if args.v0_out_delphy_metadata_file:
            with open(args.v0_out_delphy_metadata_file) as mf_:
                dphy_kwargs["metadata_json"] = mf_.read()
        dphy_out = DphyOutput(open(args.v0_out_delphy_file, "wb"), **dphy_kwargs)
        dphy_out.output_preamble(run, steps_per_sample=snap_every)
    if args.v0_out_trees_file:
        trees_out = BeastTreesOutput(open(args.v0_out_trees_file, "w"))
        trees_out.write_preamble(tree)

    granularity = math.gcd(math.gcd(log_every, tree_every), snap_every)
    stamps = deque(maxlen=10)
    done = 0
    sampled_trees = []
    while done < steps:
        chunk = min(granularity, steps - done)
        run.do_mcmc_steps(chunk)
        done += chunk
        stamps.append((run.local_moves_attempted, time.time()))
        if len(stamps) >= 2:
            (s0, w0), (s1, w1) = stamps[0], stamps[-1]
            rate = (s1 - s0) / max(w1 - w0, 1e-9)
        else:
            rate = 0.0
        print(f"{run.stats_line()}  [{rate / 1e6:.3f} Mmoves/s]", file=sys.stderr)
        if log_out and done % log_every == 0:
            log_out.write_line(run)
        if done % tree_every == 0:
            t = run.tree()
            if trees_out:
                trees_out.write_tree(t, done)
            if args.v0_out_mcc_file and done > steps // 2:  # post-burn-in
                sampled_trees.append(t)
        if args.v0_out_delphy_file and done % snap_every == 0:
            if dphy_out is not None:
                dphy_out.output_state(run)
            else:
                from .io.snapshot import save_run
                save_run(run, args.v0_out_delphy_file)
        if args.v0_paranoid:
            run.check_derived_quantities(1e-4)
    if trees_out:
        trees_out.write_epilog()
    if dphy_out is not None:
        dphy_out.output_epilog()
        dphy_out.f.close()
    if args.v0_out_mcc_file and len(sampled_trees) >= 2:
        from .mcc import derive_mcc_tree, mcc_to_nexus
        mcc = derive_mcc_tree(sampled_trees, seed=args.v0_seed)
        with open(args.v0_out_mcc_file, "w") as f:
            mcc_to_nexus(mcc, f)
        print(f"Wrote MCC tree ({len(sampled_trees)} samples) to "
              f"{args.v0_out_mcc_file}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
