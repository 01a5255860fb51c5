"""Device-side MCMC state: fixed-capacity flat arrays.

The layout deliberately matches the reference's *serialization* schema
(core/api.fbs:13-48 — nodes as {parent,left,right,t} arrays, mutations as a
flat table, missations as interval tables), which is the natural XLA memory
layout, rather than its in-memory pointer/hash-map structures.

Conventions:
  - nodes 0..T-1 are tips, T..2T-2 are inner nodes (enforced by pack_state);
  - mut_node[j] == -1 marks a free mutation-pool slot;
  - mutations with mut_node == root are root-sequence deltas vs ref_seq
    ("mutations above the root", core/phylo_tree_calc.cpp:577-585); their
    mut_t is a large negative sentinel and they never enter branch terms;
  - missation intervals / from-state exceptions are CSR-ish flat tables
    (miss_node/fs_node == -1 marks free slots).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from .phylo import FlatTree, Mutation, NO_NODE

ROOT_MUT_T = -1.0e30  # sentinel time for root-sequence deltas


class TreeState(NamedTuple):
    parent: jnp.ndarray     # i32[N]
    children: jnp.ndarray   # i32[N,2]
    t: jnp.ndarray          # f64[N]
    t_min: jnp.ndarray      # f64[N]
    t_max: jnp.ndarray      # f64[N]
    root: jnp.ndarray       # i32 scalar
    ref_seq: jnp.ndarray    # i32[L]
    mut_node: jnp.ndarray   # i32[M]
    mut_site: jnp.ndarray   # i32[M]
    mut_from: jnp.ndarray   # i32[M]
    mut_to: jnp.ndarray     # i32[M]
    mut_t: jnp.ndarray      # f64[M]
    miss_node: jnp.ndarray  # i32[K]
    miss_start: jnp.ndarray  # i32[K]
    miss_end: jnp.ndarray   # i32[K]
    fs_node: jnp.ndarray    # i32[F]
    fs_site: jnp.ndarray    # i32[F]
    fs_from: jnp.ndarray    # i32[F]

    @property
    def num_nodes(self) -> int:
        return self.parent.shape[0]

    @property
    def num_tips(self) -> int:
        return (self.parent.shape[0] + 1) // 2

    @property
    def num_sites(self) -> int:
        return self.ref_seq.shape[0]

    @property
    def is_tip(self):
        return self.children[:, 0] == NO_NODE


def _round_capacity(n: int, minimum: int = 64) -> int:
    cap = max(minimum, int(1.5 * n) + 16)
    # round up to a multiple of 128 (fewer distinct compiled shapes)
    return (cap + 127) // 128 * 128


def pack_state(tree: FlatTree, mut_capacity: int | None = None,
               miss_capacity: int | None = None, fs_capacity: int | None = None) -> TreeState:
    N = tree.num_nodes
    T = tree.num_tips
    # enforce tips-first layout
    for i in range(T):
        assert tree.is_tip(i), "pack_state requires tips at indices 0..T-1"

    muts = []
    for node in range(N):
        for m in tree.mutations[node]:
            t = ROOT_MUT_T if node == tree.root else m.t
            muts.append((node, m.site, m.from_, m.to, t))
    M = mut_capacity or _round_capacity(len(muts))
    assert len(muts) <= M

    ivs = []
    for node in range(N):
        for (s, e) in tree.miss_intervals[node]:
            ivs.append((node, s, e))
    K = miss_capacity or _round_capacity(len(ivs))
    assert len(ivs) <= K

    fss = []
    for node in range(N):
        for site, frm in tree.miss_from_states[node].items():
            fss.append((node, site, frm))
    F = fs_capacity or _round_capacity(len(fss))
    assert len(fss) <= F

    def pad(rows, cap, cols, dtypes):
        out = []
        for c, dt in zip(range(cols), dtypes):
            a = np.full(cap, -1 if np.issubdtype(dt, np.integer) else 0.0, dtype=dt)
            for j, r in enumerate(rows):
                a[j] = r[c]
            out.append(a)
        return out

    mn, ms, mf, mt_, mtime = pad(muts, M, 5, [np.int32, np.int32, np.int32, np.int32, np.float64])
    # free slots: site 0 etc are harmless because all uses mask on mut_node >= 0
    vn, vs, ve = pad(ivs, K, 3, [np.int32, np.int32, np.int32])
    fn, fsi, ffr = pad(fss, F, 3, [np.int32, np.int32, np.int32])

    return TreeState(
        parent=jnp.asarray(tree.parent, jnp.int32),
        children=jnp.asarray(tree.children, jnp.int32),
        t=jnp.asarray(tree.t, jnp.float64),
        t_min=jnp.asarray(tree.t_min, jnp.float64),
        t_max=jnp.asarray(tree.t_max, jnp.float64),
        root=jnp.asarray(tree.root, jnp.int32),
        ref_seq=jnp.asarray(tree.ref_seq, jnp.int32),
        mut_node=jnp.asarray(mn), mut_site=jnp.asarray(ms),
        mut_from=jnp.asarray(mf), mut_to=jnp.asarray(mt_),
        mut_t=jnp.asarray(mtime),
        miss_node=jnp.asarray(vn), miss_start=jnp.asarray(vs), miss_end=jnp.asarray(ve),
        fs_node=jnp.asarray(fn), fs_site=jnp.asarray(fsi), fs_from=jnp.asarray(ffr),
    )


def unpack_state(ts: TreeState, names=None) -> FlatTree:
    # Pull ALL device arrays to host first: scalar indexing of device arrays
    # would cost one device round trip per element
    h = jax.device_get(ts) if not isinstance(ts.parent, np.ndarray) else ts
    N = len(h.parent)
    parent = np.asarray(h.parent)
    children = np.asarray(h.children)
    root = int(h.root)
    mutations = [[] for _ in range(N)]
    mn = np.asarray(h.mut_node)
    msite, mfrom, mto, mt = (np.asarray(h.mut_site), np.asarray(h.mut_from),
                             np.asarray(h.mut_to), np.asarray(h.mut_t))
    for j in np.nonzero(mn >= 0)[0]:
        mutations[int(mn[j])].append(Mutation(site=int(msite[j]), from_=int(mfrom[j]),
                                              to=int(mto[j]), t=float(mt[j])))
    for node in range(N):
        mutations[node].sort(key=lambda m: (m.t, m.site))
    miss_intervals = [[] for _ in range(N)]
    vn = np.asarray(h.miss_node)
    vs, ve = np.asarray(h.miss_start), np.asarray(h.miss_end)
    for j in np.nonzero(vn >= 0)[0]:
        miss_intervals[int(vn[j])].append((int(vs[j]), int(ve[j])))
    for node in range(N):
        miss_intervals[node].sort()
    miss_from_states = [{} for _ in range(N)]
    fn = np.asarray(h.fs_node)
    fsi, ffr = np.asarray(h.fs_site), np.asarray(h.fs_from)
    for j in np.nonzero(fn >= 0)[0]:
        miss_from_states[int(fn[j])][int(fsi[j])] = int(ffr[j])
    return FlatTree(
        parent=parent.copy(), children=children.copy(),
        t=np.asarray(h.t, dtype=np.float64).copy(),
        t_min=np.asarray(h.t_min, dtype=np.float64).copy(),
        t_max=np.asarray(h.t_max, dtype=np.float64).copy(), root=root,
        ref_seq=np.asarray(h.ref_seq, dtype=np.int8).copy(),
        mutations=mutations, miss_intervals=miss_intervals,
        miss_from_states=miss_from_states,
        name=list(names) if names else [f"tip_{i}" for i in range((N + 1) // 2)],
    )


# ---------------------------------------------------------------------------
# Fused device->host transfer
# ---------------------------------------------------------------------------
#
# Every device->host transfer has a fixed latency, and jax.device_get of a
# pytree fetches leaf by leaf: pulling (TreeState, EvoParams, PopParams) is
# ~30 transfers per topology burst.  fuse_for_host concatenates
# all integer leaves into one i32 vector and all float leaves into one vector
# on the DEVICE, so the host fetch is 2 transfers; split_for_host slices the
# fetched buffers back into the original pytree structure with numpy leaves.

def _leaf_kind(x) -> str:
    dt = np.asarray(x).dtype if not hasattr(x, "dtype") else x.dtype
    return "int" if np.issubdtype(dt, np.integer) else "float"


def fuse_for_host(pytree):
    """Jit-compatible: returns (ints_i32, floats) concatenated over leaves
    in tree order.  Float dtype is the widest float leaf dtype present."""
    leaves = jax.tree_util.tree_leaves(pytree)
    ints = [jnp.ravel(jnp.asarray(l)).astype(jnp.int32)
            for l in leaves if _leaf_kind(l) == "int"]
    fls = [l for l in leaves if _leaf_kind(l) == "float"]
    fdt = jnp.result_type(*fls) if fls else jnp.float32
    flts = [jnp.ravel(jnp.asarray(l)).astype(fdt) for l in fls]
    z_i = jnp.zeros((0,), jnp.int32)
    z_f = jnp.zeros((0,), fdt)
    return (jnp.concatenate(ints) if ints else z_i,
            jnp.concatenate(flts) if flts else z_f)


_fuse_for_host_jit = jax.jit(fuse_for_host)


def split_for_host(template, ints_h, flts_h):
    """Host-side inverse of fuse_for_host: rebuild `template`'s structure
    with numpy leaves sliced from the two fetched buffers (original shapes
    and dtypes restored; 0-d leaves come back as numpy scalars)."""
    leaves, treedef = jax.tree_util.tree_flatten(template)
    ints_h = np.asarray(ints_h)
    flts_h = np.asarray(flts_h)
    oi = of = 0
    out = []
    for l in leaves:
        # read shape/dtype WITHOUT materializing the leaf: np.asarray on a
        # device array is a device->host transfer, one per leaf
        if hasattr(l, "shape") and hasattr(l, "dtype"):
            shape, dtype = l.shape, np.dtype(str(l.dtype))
        else:
            la = np.asarray(l)
            shape, dtype = la.shape, la.dtype
        n = int(np.prod(shape)) if shape else 1
        if _leaf_kind(l) == "int":
            v = ints_h[oi:oi + n].reshape(shape).astype(dtype)
            oi += n
        else:
            v = flts_h[of:of + n].reshape(shape).astype(dtype)
            of += n
        out.append(v if shape else v[()])
    return jax.tree_util.tree_unflatten(treedef, out)


def fetch_fused(pytree):
    """device_get the whole pytree in 2 transfers (see fuse_for_host)."""
    ints_h, flts_h = jax.device_get(_fuse_for_host_jit(pytree))
    return split_for_host(pytree, ints_h, flts_h)
