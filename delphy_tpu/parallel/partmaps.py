"""Host-side construction of static partition index maps.

Mirrors the *structure* of Run::repartition (core/run.cpp:110-190) and
partition_tree (core/tree_partitioning.h:196-239): the tree is cut at stencil
cut points; a cut point is the root of its own part and appears as a FROZEN
leaf in its parent part (t pinned), so every global branch belongs to exactly
one part and the EMAT log-likelihood factorizes over parts.

Unlike the host topology path (topo/partition.py), the device sweep never
needs self-contained part *trees* (no subroot sequences, no missation
re-rooting): local moves only change node times and mutation times, so the
parts are pure index VIEWS of the global flat arrays:

  node_map[p, i]  part-local node i  ->  global node index
  mut_map[p, j]   part-local mutation slot j -> global mutation-pool slot

All maps are static between repartitions (topology moves run at burst
boundaries and trigger a rebuild), so the whole partitioned sweep jits with
fixed shapes, and the same maps drive both the single-chip vmap path and the
multi-chip shard_map path.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..phylo import FlatTree, NO_NODE
from ..topo.partition import generate_random_partition_stencil


class PartMaps(NamedTuple):
    """Static per-partition index maps (host-built, device-resident).

    Shapes: P parts, n_cap nodes/part, m_cap mutation slots/part.
    Part-local node layout is leaves-first: local indices [0, n_leaves) are
    part leaves (real tips + frozen cut points), [n_leaves, n_nodes) are part
    inner nodes (including the part root)."""
    node_map: np.ndarray      # i32[P, n_cap] global node, -1 pad
    parent: np.ndarray        # i32[P, n_cap] part-local parent, -1 for part root/pad
    children: np.ndarray      # i32[P, n_cap, 2] part-local children, -1 leaves/pads
    part_root: np.ndarray     # i32[P] part-local root index
    is_run_root: np.ndarray   # bool[P] whether this part holds the global root
    n_leaves: np.ndarray      # i32[P]
    n_nodes: np.ndarray       # i32[P]
    sign: np.ndarray          # f64[P, n_cap] lineage-count signs (see below)
    owned_idx: np.ndarray     # i32[P, n_cap] global node for time scatter, N = trash
    t_min: np.ndarray         # f64[P, n_cap] (frozen leaves: pinned, inners: -inf)
    t_max: np.ndarray         # f64[P, n_cap]
    mut_map: np.ndarray       # i32[P, m_cap] global pool slot, -1 pad
    mut_scatter: np.ndarray   # i32[P, m_cap] global pool slot, M = trash
    mut_node_local: np.ndarray  # i32[P, m_cap] part-local branch node, -1 pad
    part_t_lo: np.ndarray     # f64[P] earliest reachable part time (-inf for root part)
    part_t_hi: np.ndarray     # f64[P] latest reachable part time
    part_id: np.ndarray       # i32[P] global part index (for RNG fold_in)

    @property
    def num_parts(self) -> int:
        return self.node_map.shape[0]

    @property
    def n_cap(self) -> int:
        return self.node_map.shape[1]

    @property
    def m_cap(self) -> int:
        return self.mut_map.shape[1]


def host_mut_nodes(tree: FlatTree, mut_capacity: int) -> np.ndarray:
    """Host mirror of the packed pool's slot->node map, in pack_state's
    deterministic node-order layout (state.py:pack_state)."""
    out = np.full(mut_capacity, -1, np.int32)
    j = 0
    for node in range(tree.num_nodes):
        for _m in tree.mutations[node]:
            out[j] = node
            j += 1
    return out


def pad_part_maps(pm: "PartMaps", P: int, n_cap: int, m_cap: int,
                  num_nodes: int, num_mut_slots: int) -> "PartMaps":
    """Pad maps to sticky capacities (P parts x n_cap nodes x m_cap mutation
    slots) so repartitioning never changes jit shapes.  Padding parts are
    empty (n_nodes = 0) and padding entries route to trash indices; the sweep
    no-ops on them."""
    P0, nc0 = pm.node_map.shape
    mc0 = pm.mut_map.shape[1]
    assert P0 <= P and nc0 <= n_cap and mc0 <= m_cap, "sticky caps must grow"

    def pad2(a, cap, fill):
        out = np.full((P, cap), fill, a.dtype)
        out[:P0, :a.shape[1]] = a
        return out

    def pad1(a, fill):
        out = np.full(P, fill, a.dtype)
        out[:P0] = a
        return out

    children = np.full((P, n_cap, 2), -1, pm.children.dtype)
    children[:P0, :nc0] = pm.children
    return PartMaps(
        node_map=pad2(pm.node_map, n_cap, -1),
        parent=pad2(pm.parent, n_cap, -1),
        children=children,
        part_root=pad1(pm.part_root, 0),
        is_run_root=pad1(pm.is_run_root, False),
        n_leaves=pad1(pm.n_leaves, 0),
        n_nodes=pad1(pm.n_nodes, 0),
        sign=pad2(pm.sign, n_cap, 0.0),
        owned_idx=pad2(pm.owned_idx, n_cap, num_nodes),
        t_min=pad2(pm.t_min, n_cap, 0.0),
        t_max=pad2(pm.t_max, n_cap, 0.0),
        mut_map=pad2(pm.mut_map, m_cap, -1),
        mut_scatter=pad2(pm.mut_scatter, m_cap, num_mut_slots),
        mut_node_local=pad2(pm.mut_node_local, m_cap, -1),
        # empty padding parts must never count as active (vsc A per cell)
        part_t_lo=pad1(pm.part_t_lo, np.inf),
        part_t_hi=pad1(pm.part_t_hi, -np.inf),
        part_id=np.arange(P, dtype=np.int32))


def auto_num_partitions(num_tips: int, max_parts: int = 32) -> int:
    """Default partition count: same spirit as the reference's
    threads-as-partitions default (tools/delphy.cpp:130-132), scaled for
    data-parallel device sweeps; stencil generation needs >=10 branches
    per part (tree_partitioning.h:139-194).

    Above ~5k tips the cap grows so per-part node capacity stays ~<=512
    (parts are the sweep's parallel axis, so many small parts beat few big
    ones)."""
    import os
    env = os.environ.get("DELPHY_TPU_P", "")
    if env:
        return max(1, int(env))
    # ~2N/P <= 300 with stencil imbalance headroom, rounded up to a multiple
    # of 8.  Both constants fix the compiled shapes (and so the
    # trajectories); re-tuning them for the GPU is a ROADMAP item.
    need = max(max_parts, -(-2 * num_tips // 300))
    need = (need + 7) // 8 * 8
    return max(1, min(num_tips // 10, need))


# default hard cap on nodes per part (it fixes the compiled n_cap at scale)
PART_SIZE_CAP = 768


def part_size_cap() -> int:
    """Hard upper bound on nodes per part, enforced by the oversized-part
    splitter (topo.partition.split_oversized_cuts) for multi-part runs.
    DELPHY_TPU_PART_CAP overrides the default of PART_SIZE_CAP nodes."""
    import os
    cap = int(os.environ.get("DELPHY_TPU_PART_CAP", "0"))
    return cap if cap > 0 else PART_SIZE_CAP


def _round8(n: int) -> int:
    return (max(n, 4) + 7) // 8 * 8


def build_part_maps(tree: FlatTree, mut_node: np.ndarray,
                    num_parts: int, rng: np.random.Generator,
                    return_cuts: bool = False) -> PartMaps:
    """Build PartMaps from the current tree + the packed global mutation pool.

    mut_node: host copy of TreeState.mut_node (global pool slot -> global node,
    -1 free).  Root-sequence deltas (slots on the global root) belong to no
    part — the sweep never touches them.

    return_cuts: also return the final cut-point list (post-splitter, root
    excluded).  topo.partition.partition_tree over the same list produces
    host parts in the SAME order as these maps' part rows (both sort the cut
    set by (c != root, c)) — the correspondence the overlapped topology
    driver relies on."""
    N = tree.num_nodes
    root = int(tree.root)
    # best-of-K stencils by max part size: the greedy generator's residual
    # root part routinely overshoots the mean 3-4x, and n_cap (hence every
    # compiled per-part shape) is set by the WORST part.  The
    # reference similarly keeps a cache of 10 stencils (run.cpp:87-108).
    cut_points: list = []
    if num_parts > 1:
        cut_points, sizes = generate_random_partition_stencil(
            tree, num_parts, rng, return_sizes=True, tries=6)
        best_mx = max(sizes)
        # hard-cap the worst part: best-of-6 still overshoots the mean 3-8x
        # at 100k tips, and n_cap (every per-part shape) is set by the
        # worst part.
        cap = part_size_cap()
        if best_mx is not None and best_mx > cap:
            from ..topo.partition import split_oversized_cuts
            cut_points = split_oversized_cuts(tree, cut_points, cap)
    cut_set = set(int(c) for c in cut_points)
    cut_set.add(root)

    # collect part node lists (global indices), leaves-first
    parts_nodes = []     # list of (ordered_globals, n_leaves, cut)
    for cut in sorted(cut_set, key=lambda c: (c != root, c)):
        nodes = []
        stack = [cut]
        while stack:
            n = stack.pop()
            nodes.append(n)
            if not tree.is_tip(n):
                for c in tree.children[n]:
                    c = int(c)
                    if c in cut_set:
                        nodes.append(c)     # frozen leaf boundary
                    else:
                        stack.append(c)

        def is_leaf(n, cut=cut):
            return tree.is_tip(n) or (n in cut_set and n != cut)
        leaves = [n for n in nodes if is_leaf(n)]
        inners = [n for n in nodes if not is_leaf(n)]
        parts_nodes.append((leaves + inners, len(leaves), cut))

    P = len(parts_nodes)
    n_cap = _round8(max(len(o) for o, _, _ in parts_nodes))

    node_map = np.full((P, n_cap), -1, np.int32)
    parent = np.full((P, n_cap), -1, np.int32)
    children = np.full((P, n_cap, 2), -1, np.int32)
    part_root = np.zeros(P, np.int32)
    is_run_root = np.zeros(P, bool)
    n_leaves_arr = np.zeros(P, np.int32)
    n_nodes_arr = np.zeros(P, np.int32)
    sign = np.zeros((P, n_cap), np.float64)
    owned_idx = np.full((P, n_cap), N, np.int32)
    t_min = np.zeros((P, n_cap), np.float64)
    t_max = np.zeros((P, n_cap), np.float64)
    part_t_lo = np.zeros(P, np.float64)
    part_t_hi = np.zeros(P, np.float64)

    # global node -> (owner part, local index) at its NON-ROOT appearance;
    # the run root's only appearance is as its own part's root
    owner_part = np.full(N, -1, np.int64)
    owner_local = np.full(N, -1, np.int64)

    for p, (ordered, n_leaves, cut) in enumerate(parts_nodes):
        local_of = {g: i for i, g in enumerate(ordered)}
        Np = len(ordered)
        node_map[p, :Np] = ordered
        part_root[p] = local_of[cut]
        is_run_root[p] = (cut == root)
        n_leaves_arr[p] = n_leaves
        n_nodes_arr[p] = Np
        for i, g in enumerate(ordered):
            leaf = i < n_leaves
            if leaf:
                if tree.is_tip(g):
                    t_min[p, i] = tree.t_min[g]
                    t_max[p, i] = tree.t_max[g]
                else:  # frozen cut point: pinned (run.cpp:166-169)
                    t_min[p, i] = t_max[p, i] = tree.t[g]
                sign[p, i] = 1.0
            else:
                t_min[p, i] = -np.inf
                t_max[p, i] = np.inf
                if g == cut:
                    # part root: -1 closes the global root lineage into the
                    # past; -2 cancels against the +1 frozen-leaf appearance
                    # in the parent part so global signs sum to -1
                    sign[p, i] = -1.0 if cut == root else -2.0
                else:
                    sign[p, i] = -1.0
            if not (leaf and not tree.is_tip(g)):
                # owned: every appearance except frozen cut leaves
                owned_idx[p, i] = g
            if g != cut:
                owner_part[g] = p
                owner_local[g] = i
            # part-local topology (only where both endpoints are in-part)
            if not leaf and not tree.is_tip(g):
                a = local_of[int(tree.children[g, 0])]
                b = local_of[int(tree.children[g, 1])]
                children[p, i] = (a, b)
            if g != cut:
                parent[p, i] = local_of[int(tree.parent[g])]
        finite_hi = t_max[p, :n_leaves]
        part_t_hi[p] = float(np.max(finite_hi[np.isfinite(finite_hi)]))
        part_t_lo[p] = -np.inf if cut == root else float(tree.t[cut])
    owner_part[root] = next(p for p in range(P) if is_run_root[p])
    owner_local[root] = part_root[owner_part[root]]

    # mutation-pool maps: slot j on global node n (branch above n) belongs to
    # the part where n is a non-root node; global-root deltas are unmapped
    mut_node = np.asarray(mut_node)
    M = mut_node.shape[0]
    valid = (mut_node >= 0) & (mut_node != root)
    slots = np.nonzero(valid)[0]
    owners = owner_part[mut_node[slots]]
    locs = owner_local[mut_node[slots]]
    counts = np.bincount(owners, minlength=P)
    m_cap = _round8(int(counts.max()) if len(slots) else 4)
    mut_map = np.full((P, m_cap), -1, np.int32)
    mut_scatter = np.full((P, m_cap), M, np.int32)
    mut_node_local = np.full((P, m_cap), -1, np.int32)
    fill = np.zeros(P, np.int64)
    order = np.argsort(owners, kind="stable")
    for k in order:
        p = int(owners[k])
        j = fill[p]
        fill[p] = j + 1
        mut_map[p, j] = slots[k]
        mut_scatter[p, j] = slots[k]
        mut_node_local[p, j] = locs[k]

    pm = PartMaps(
        node_map=node_map, parent=parent, children=children,
        part_root=part_root, is_run_root=is_run_root,
        n_leaves=n_leaves_arr, n_nodes=n_nodes_arr, sign=sign,
        owned_idx=owned_idx, t_min=t_min, t_max=t_max,
        mut_map=mut_map, mut_scatter=mut_scatter,
        mut_node_local=mut_node_local,
        part_t_lo=part_t_lo, part_t_hi=part_t_hi,
        part_id=np.arange(P, dtype=np.int32))
    if return_cuts:
        return pm, sorted(c for c in cut_set if c != root)
    return pm
