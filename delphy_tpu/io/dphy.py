""".dphy v3 binary run-snapshot stream: format-compatible writer + reader.

Re-implements the reference's Delphy_output (core/delphy_output.{h,cpp}) and
the flatbuffers state schema (core/api.fbs, doc/dphy_file_format.md:15-52) so
runs can be exchanged with delphy / delphy-web:

  stream := 'DPHY' u32(version=3)
            str(core_version) u32(build) str(commit)
            u32(knee_index) u32(steps_per_sample)
            u32(alpha_move_enabled) u32(mpox_hack_enabled)
            u32(mu_move_enabled) f32(mu)
            fb(TreeInfo)
            { u32(len tree_fb) u32(len params_fb) tree_fb params_fb }*
            u32(0)  str(metadata_json)  u64(pos of the 0 sentinel)

All flatbuffers are size-prefixed (FinishSizePrefixed, api.cpp:95,123,313);
the u32 length written before each buffer INCLUDES the 4-byte size prefix
(delphy_output.cpp:76-92).

The table builders use the flatbuffers python runtime with explicit slot ids
from api.fbs (slot id -> vtable offset 4+2*id, verified against
api_generated.h VT_* constants).  Struct vectors (Node/Mutation/
MissationInterval) are bulk-packed with numpy for speed at 100k-tip scale.
"""

from __future__ import annotations

import json
import struct

import numpy as np
import flatbuffers

from ..phylo import FlatTree, Mutation, NO_NODE
from .. import pop as popm

MAGIC = b"DPHY"
VERSION = 3
DEFAULT_METADATA = ("{\"confidence\":90,\"topology\":0,\"presentation\":0,"
                    "\"spacing\":0,\"colorBy\":0,\"burnin\":0,"
                    "\"metadataPresent\":0,\"metadataText\":null,"
                    "\"metadataFile\":null,\"metadataDelimiter\":null,"
                    "\"selectedMDField\":-1,\"metadataColors\":{}}")

# Params field slot ids (api.fbs table Params)
_P = dict(step=0, num_local_moves_per_global_move=1, num_parts=2, mu=3,
          alpha=4, nu=5, hky_kappa=6, hky_pi_A=7, hky_pi_C=8, hky_pi_G=9,
          hky_pi_T=10, pop_n0=11, pop_g=12, only_displacing_inner_nodes=13,
          topology_moves_enabled=14, repartitioning_enabled=15,
          alpha_move_enabled=16, log_posterior=17, log_other_priors=18,
          log_coalescent_prior=19, log_G=20, total_branch_length=21,
          mpox_hack_enabled=22, mpox_mu=23, mpox_mu_star=24,
          mu_move_enabled=25, pop_t0=26, final_pop_size_move_enabled=27,
          pop_growth_rate_move_enabled=28, pop_model_type=29, pop_model=30,
          skygrid_tau=31, skygrid_tau_prior_alpha=32,
          skygrid_tau_prior_beta=33, skygrid_tau_move_enabled=34,
          skygrid_low_gamma_barrier_enabled=35,
          skygrid_low_gamma_barrier_loc=36, skygrid_low_gamma_barrier_scale=37,
          mu_prior_alpha=38, mu_prior_beta=39, pop_inv_n0_prior_alpha=40,
          pop_inv_n0_prior_beta=41, pop_g_prior_mu=42, pop_g_prior_scale=43,
          pop_g_min=44, pop_g_max=45, skygrid_inv_nbar_prior_alpha=46,
          skygrid_inv_nbar_prior_beta=47)
_NUM_PARAMS_SLOTS = 48

POP_MODEL_NONE = 0
POP_MODEL_EXP = 1
POP_MODEL_SKYGRID = 2


# ---------------------------------------------------------------------------
# low-level helpers
# ---------------------------------------------------------------------------

def _prepend_raw(b: flatbuffers.Builder, raw: bytes):
    """Bulk-prepend raw bytes (capacity already ensured by StartVector)."""
    b.head = b.head - len(raw)
    b.Bytes[b.head:b.head + len(raw)] = raw


def _struct_vector(b: flatbuffers.Builder, elem_size: int, raw: bytes):
    n = len(raw) // elem_size
    b.StartVector(elem_size, n, 4)
    _prepend_raw(b, raw)
    return b.EndVector()


def _f64_vector(b: flatbuffers.Builder, xs: np.ndarray):
    xs = np.ascontiguousarray(xs, np.float64)
    b.StartVector(8, len(xs), 8)
    _prepend_raw(b, xs.tobytes())
    return b.EndVector()


def _u8_vector(b: flatbuffers.Builder, xs: np.ndarray):
    xs = np.ascontiguousarray(xs, np.uint8)
    b.StartVector(1, len(xs), 1)
    _prepend_raw(b, xs.tobytes())
    return b.EndVector()


# ---------------------------------------------------------------------------
# flatbuffer builders (Tree / TreeInfo / Params)
# ---------------------------------------------------------------------------

def build_tree_fb(tree: FlatTree) -> bytes:
    """Size-prefixed api.Tree flatbuffer (phylo_tree_to_api_tree,
    core/api.cpp:34-96)."""
    N = tree.num_nodes

    # nodes: struct {parent:i32, left:i32, right:i32, t:f32}, 16 bytes
    nodes = np.empty((N, 4), np.int32)
    nodes[:, 0] = tree.parent
    nodes[:, 1] = tree.children[:, 0]
    nodes[:, 2] = tree.children[:, 1]
    nodes[:, 3] = np.asarray(tree.t, np.float32).view(np.int32)
    nodes[tree.root, 0] = -1
    tips = tree.children[:, 0] == NO_NODE
    nodes[tips, 1] = -1
    nodes[tips, 2] = -1

    # mutations: struct {branch:i32, site:i32, from:u8, to:u8, pad2, t:f32}
    muts = []
    for n in range(N):
        for m in tree.mutations[n]:
            muts.append((n, m.site, m.from_, m.to, m.t))
    M = len(muts)
    mut_raw = np.zeros((M, 4), np.int32)
    if M:
        arr = np.array(muts, np.float64)
        mut_raw[:, 0] = arr[:, 0].astype(np.int32)
        mut_raw[:, 1] = arr[:, 1].astype(np.int32)
        packed = (arr[:, 2].astype(np.uint32) |
                  (arr[:, 3].astype(np.uint32) << 8))
        mut_raw[:, 2] = packed.astype(np.int32)
        mut_raw[:, 3] = arr[:, 4].astype(np.float32).view(np.int32)

    # missation intervals: struct {branch:i32, start:i32, end:i32}
    ivs = []
    for n in range(N):
        for (s, e) in tree.miss_intervals[n]:
            ivs.append((n, s, e))
    iv_raw = np.array(ivs, np.int32).reshape(-1, 3)

    b = flatbuffers.Builder(64 + 16 * N + 16 * M + 12 * len(ivs) +
                            tree.num_sites)
    ref_off = _u8_vector(b, np.asarray(tree.ref_seq, np.uint8))
    iv_off = _struct_vector(b, 12, iv_raw.tobytes())
    mut_off = _struct_vector(b, 16, mut_raw.tobytes())
    nodes_off = _struct_vector(b, 16, nodes.tobytes())

    b.StartObject(5)
    b.PrependUOffsetTRelativeSlot(0, nodes_off, 0)
    b.PrependUOffsetTRelativeSlot(1, mut_off, 0)
    b.PrependUOffsetTRelativeSlot(2, iv_off, 0)
    b.PrependUOffsetTRelativeSlot(3, ref_off, 0)
    b.PrependInt32Slot(4, int(tree.root), 0)
    root = b.EndObject()
    b.FinishSizePrefixed(root)
    return bytes(b.Output())


def build_tree_info_fb(tree: FlatTree) -> bytes:
    """Size-prefixed api.TreeInfo (phylo_tree_to_api_tree_info,
    core/api.cpp:99-124)."""
    b = flatbuffers.Builder(1024)
    N = tree.num_nodes
    names = tree.name if tree.name else [""] * N
    node_offs = []
    for n in range(N):
        name_off = b.CreateString(names[n] if n < len(names) and names[n]
                                  else "")
        uncertain = (tree.is_tip(n)
                     and float(tree.t_min[n]) < float(tree.t_max[n]))
        b.StartObject(4)
        b.PrependUOffsetTRelativeSlot(0, name_off, 0)
        if uncertain:
            b.PrependBoolSlot(1, True, False)
            b.PrependFloat32Slot(2, float(tree.t_min[n]), 0.0)
            b.PrependFloat32Slot(3, float(tree.t_max[n]), 0.0)
        node_offs.append(b.EndObject())
    b.StartVector(4, N, 4)
    for off in reversed(node_offs):
        b.PrependUOffsetTRelative(off)
    vec = b.EndVector()
    b.StartObject(1)
    b.PrependUOffsetTRelativeSlot(0, vec, 0)
    root = b.EndObject()
    b.FinishSizePrefixed(root)
    return bytes(b.Output())


def build_params_fb(run) -> bytes:
    """Size-prefixed api.Params from a Run (run_to_api_params,
    core/api.cpp:210-315)."""
    import jax
    evo, hyp = jax.device_get(run.evo), run.hyp
    pop = jax.device_get(run.pop)
    ledger = run.ledger
    b = flatbuffers.Builder(1024 + 8 * evo.nu.shape[0])

    nu = np.asarray(evo.nu, np.float64)
    nu_off = _f64_vector(b, nu) if not np.all(nu == 1.0) else None

    if isinstance(run.pop, popm.SkygridPopParams):
        x_off = _f64_vector(b, pop.x)
        g_off = _f64_vector(b, pop.gamma)
        b.StartObject(3)
        fb_type = 2 if run.pop.type == popm.LOG_LINEAR else 1
        b.PrependInt8Slot(0, fb_type, 1)
        b.PrependUOffsetTRelativeSlot(1, x_off, 0)
        b.PrependUOffsetTRelativeSlot(2, g_off, 0)
        pop_off, pop_type = b.EndObject(), POP_MODEL_SKYGRID
    else:
        b.StartObject(4)
        b.PrependFloat64Slot(0, float(pop.t0), 0.0)
        b.PrependFloat64Slot(1, float(pop.n0), 0.0)
        b.PrependFloat64Slot(2, float(pop.g), 0.0)
        b.PrependFloat64Slot(3, float(pop.min_pop), 0.0)
        pop_off, pop_type = b.EndObject(), POP_MODEL_EXP

    def S(name):
        return _P[name]

    b.StartObject(_NUM_PARAMS_SLOTS)
    b.PrependInt64Slot(S("step"), int(run.step), 0)
    b.PrependInt64Slot(S("num_local_moves_per_global_move"),
                       int(run.local_moves_per_global_move), -1)
    b.PrependInt32Slot(S("num_parts"), int(run.device_partitions), 0)
    b.PrependFloat64Slot(S("mu"), float(evo.mu), 0.0)
    b.PrependFloat64Slot(S("mu_prior_alpha"), hyp.mu_prior_alpha, 1.0)
    b.PrependFloat64Slot(S("mu_prior_beta"), hyp.mu_prior_beta, 0.0)
    b.PrependFloat64Slot(S("alpha"), float(evo.alpha), 0.0)
    if nu_off is not None:
        b.PrependUOffsetTRelativeSlot(S("nu"), nu_off, 0)
    b.PrependFloat64Slot(S("hky_kappa"), float(evo.kappa), 0.0)
    pi = np.asarray(evo.pi, np.float64)
    for i, nm in enumerate(["hky_pi_A", "hky_pi_C", "hky_pi_G", "hky_pi_T"]):
        b.PrependFloat64Slot(S(nm), float(pi[i]), 0.0)
    b.PrependUint8Slot(S("pop_model_type"), pop_type, 0)
    b.PrependUOffsetTRelativeSlot(S("pop_model"), pop_off, 0)
    b.PrependFloat64Slot(S("pop_inv_n0_prior_alpha"),
                         hyp.pop_inv_n0_prior_alpha, 0.0)
    b.PrependFloat64Slot(S("pop_inv_n0_prior_beta"),
                         hyp.pop_inv_n0_prior_beta, 0.0)
    b.PrependFloat64Slot(S("pop_g_prior_mu"), hyp.pop_g_prior_mu, 0.0)
    b.PrependFloat64Slot(S("pop_g_prior_scale"), hyp.pop_g_prior_scale, 0.0)
    if np.isfinite(hyp.pop_g_min):
        b.PrependFloat64Slot(S("pop_g_min"), hyp.pop_g_min, 0.0)
    if np.isfinite(hyp.pop_g_max):
        b.PrependFloat64Slot(S("pop_g_max"), hyp.pop_g_max, 0.0)
    if isinstance(run.pop, popm.SkygridPopParams):
        b.PrependFloat64Slot(S("skygrid_tau"), float(pop.tau), 0.0)
        b.PrependFloat64Slot(S("skygrid_tau_prior_alpha"),
                             hyp.skygrid_tau_prior_alpha, 0.0)
        b.PrependFloat64Slot(S("skygrid_tau_prior_beta"),
                             hyp.skygrid_tau_prior_beta, 0.0)
        b.PrependFloat64Slot(S("skygrid_low_gamma_barrier_loc"),
                             hyp.skygrid_low_gamma_barrier_loc, 0.0)
        b.PrependFloat64Slot(S("skygrid_low_gamma_barrier_scale"),
                             hyp.skygrid_low_gamma_barrier_scale, 0.0)
        b.PrependFloat64Slot(S("skygrid_inv_nbar_prior_alpha"),
                             hyp.skygrid_inv_nbar_prior_alpha, 0.0)
        b.PrependFloat64Slot(S("skygrid_inv_nbar_prior_beta"),
                             hyp.skygrid_inv_nbar_prior_beta, 0.0)
        b.PrependBoolSlot(S("skygrid_tau_move_enabled"),
                          hyp.skygrid_tau_move_enabled, False)
        b.PrependBoolSlot(S("skygrid_low_gamma_barrier_enabled"),
                          hyp.skygrid_low_gamma_barrier_enabled, False)
    else:
        # deprecated hard-coded exp-pop fields, kept for compatibility
        b.PrependFloat64Slot(S("pop_t0"), float(pop.t0), 0.0)
        b.PrependFloat64Slot(S("pop_n0"), float(pop.n0), 0.0)
        b.PrependFloat64Slot(S("pop_g"), float(pop.g), 0.0)
    b.PrependBoolSlot(S("topology_moves_enabled"),
                      run.topology_moves_enabled, False)
    b.PrependBoolSlot(S("repartitioning_enabled"), True, False)
    b.PrependBoolSlot(S("alpha_move_enabled"), hyp.alpha_move_enabled, False)
    b.PrependBoolSlot(S("mu_move_enabled"), hyp.mu_move_enabled, True)
    b.PrependBoolSlot(S("final_pop_size_move_enabled"),
                      hyp.pop_size_move_enabled, True)
    b.PrependBoolSlot(S("pop_growth_rate_move_enabled"),
                      hyp.pop_growth_rate_move_enabled, True)
    if ledger is not None:
        lg = float(ledger.log_G)
        lc = float(ledger.log_coal)
        lo = float(ledger.log_other)
        b.PrependFloat64Slot(S("log_posterior"), lg + lc + lo, 0.0)
        b.PrependFloat64Slot(S("log_other_priors"), lo, 0.0)
        b.PrependFloat64Slot(S("log_coalescent_prior"), lc, 0.0)
        b.PrependFloat64Slot(S("log_G"), lg, 0.0)
    if hyp.mpox_enabled:
        b.PrependBoolSlot(S("mpox_hack_enabled"), True, False)
        b.PrependFloat64Slot(S("mpox_mu"), float(evo.mu), 0.0)
        b.PrependFloat64Slot(S("mpox_mu_star"),
                             float(evo.mu * evo.mpox_rho), 0.0)
    root = b.EndObject()
    b.FinishSizePrefixed(root)
    return bytes(b.Output())


# ---------------------------------------------------------------------------
# stream writer
# ---------------------------------------------------------------------------

class DphyOutput:
    """Streaming .dphy writer (Delphy_output, core/delphy_output.cpp)."""

    def __init__(self, f, metadata_json: str = DEFAULT_METADATA):
        self.f = f
        self.metadata_json = metadata_json

    def _u32(self, x):
        self.f.write(struct.pack("<I", x & 0xFFFFFFFF))

    def _u64(self, x):
        self.f.write(struct.pack("<Q", x))

    def _f32(self, x):
        self.f.write(struct.pack("<f", x))

    def _str(self, s: str):
        bs = s.encode("utf-8")
        self._u32(len(bs))
        self.f.write(bs)

    def _fb(self, buf: bytes):
        self._u32(len(buf))
        self.f.write(buf)

    def output_preamble(self, run, steps_per_sample: int):
        from ..version import __version__ as CORE_VERSION
        self.f.write(MAGIC)
        self._u32(VERSION)
        self._str(CORE_VERSION)
        self._u32(0)            # build number
        self._str("delphy_tpu")  # commit string
        self._u32(0)            # knee index
        self._u32(steps_per_sample)
        self._u32(1 if run.hyp.alpha_move_enabled else 0)
        self._u32(1 if run.hyp.mpox_enabled else 0)
        self._u32(1 if run.hyp.mu_move_enabled else 0)
        self._f32(float(run.evo.mu))
        self._fb(build_tree_info_fb(run.tree()))

    def output_state(self, run):
        tree_fb = build_tree_fb(run.tree())
        params_fb = build_params_fb(run)
        self._u32(len(tree_fb))
        self._u32(len(params_fb))
        self.f.write(tree_fb)
        self.f.write(params_fb)

    def output_epilog(self):
        pos = self.f.tell()
        self._u32(0)
        self._str(self.metadata_json)
        self._u64(pos)


# ---------------------------------------------------------------------------
# flatbuffer reader (minimal vtable walker)
# ---------------------------------------------------------------------------

class _Table:
    def __init__(self, buf: bytes, pos: int):
        self.buf = buf
        self.pos = pos
        vt_off = struct.unpack_from("<i", buf, pos)[0]
        self.vt = pos - vt_off
        self.vt_size = struct.unpack_from("<H", buf, self.vt)[0]

    def _field(self, slot: int) -> int:
        """Absolute position of field data, or 0 if absent."""
        off = 4 + 2 * slot
        if off >= self.vt_size:
            return 0
        rel = struct.unpack_from("<H", buf := self.buf, self.vt + off)[0]
        del buf
        return self.pos + rel if rel else 0

    def scalar(self, slot: int, fmt: str, default):
        p = self._field(slot)
        return struct.unpack_from("<" + fmt, self.buf, p)[0] if p else default

    def indirect(self, slot: int):
        p = self._field(slot)
        if not p:
            return None
        return p + struct.unpack_from("<I", self.buf, p)[0]

    def vector(self, slot: int, dtype, elem_size: int):
        p = self.indirect(slot)
        if p is None:
            return np.empty(0, dtype)
        n = struct.unpack_from("<I", self.buf, p)[0]
        return np.frombuffer(self.buf, dtype, count=n * elem_size //
                             np.dtype(dtype).itemsize, offset=p + 4)

    def string(self, slot: int, default=""):
        p = self.indirect(slot)
        if p is None:
            return default
        n = struct.unpack_from("<I", self.buf, p)[0]
        return self.buf[p + 4:p + 4 + n].decode("utf-8")

    def table(self, slot: int):
        p = self.indirect(slot)
        return _Table(self.buf, p) if p is not None else None


def _root(buf: bytes) -> _Table:
    """Root table of a size-prefixed flatbuffer."""
    root_off = struct.unpack_from("<I", buf, 4)[0]
    return _Table(buf, 4 + root_off)


def parse_tree_fb(buf: bytes, names=None) -> FlatTree:
    t = _root(buf)
    nodes = t.vector(0, np.int32, 16).reshape(-1, 4)
    muts = t.vector(1, np.int32, 16).reshape(-1, 4)
    ivs = t.vector(2, np.int32, 12).reshape(-1, 3)
    ref = t.vector(3, np.uint8, 1).astype(np.int8)
    root = t.scalar(4, "i", 0)

    N = nodes.shape[0]
    parent = nodes[:, 0].astype(np.int32).copy()
    children = nodes[:, 1:3].astype(np.int32).copy()
    tvals = nodes[:, 3].view(np.float32).astype(np.float64)
    parent[parent < 0] = NO_NODE
    children[children < 0] = NO_NODE

    mutations = [[] for _ in range(N)]
    for k in range(muts.shape[0]):
        branch = int(muts[k, 0])
        site = int(muts[k, 1])
        ft = int(muts[k, 2])
        tt = float(np.int32(muts[k, 3]).view(np.float32))
        mutations[branch].append(Mutation(from_=ft & 0xFF, site=site,
                                          to=(ft >> 8) & 0xFF, t=tt))
    for n in range(N):
        mutations[n].sort(key=lambda m: (m.t, m.site))

    miss_intervals = [[] for _ in range(N)]
    for k in range(ivs.shape[0]):
        miss_intervals[int(ivs[k, 0])].append((int(ivs[k, 1]),
                                               int(ivs[k, 2])))

    t_min = tvals.copy()
    t_max = tvals.copy()
    inner = children[:, 0] != NO_NODE
    t_min[inner] = -np.inf
    t_max[inner] = np.inf

    tree = FlatTree(parent=parent, children=children, t=tvals, t_min=t_min,
                    t_max=t_max, root=int(root), ref_seq=ref,
                    mutations=mutations, miss_intervals=miss_intervals,
                    miss_from_states=[{} for _ in range(N)],
                    name=list(names) if names else [""] * N)
    from ..phylo import fix_up_missations
    fix_up_missations(tree)
    return tree


def parse_tree_info_fb(buf: bytes):
    """-> (names, t_min/t_max overrides: dict node -> (t_min, t_max))."""
    t = _root(buf)
    p = t.indirect(0)
    if p is None:
        return [], {}
    n = struct.unpack_from("<I", t.buf, p)[0]
    names, uncertain = [], {}
    for i in range(n):
        ep = p + 4 + 4 * i
        ni = _Table(t.buf, ep + struct.unpack_from("<I", t.buf, ep)[0])
        names.append(ni.string(0))
        if ni.scalar(1, "B", 0):
            uncertain[i] = (ni.scalar(2, "f", 0.0), ni.scalar(3, "f", 0.0))
    return names, uncertain


def parse_params_fb(buf: bytes) -> dict:
    t = _root(buf)
    out = {}
    for name, slot in _P.items():
        if name in ("nu", "pop_model"):
            continue
        fmt = {"step": "q", "num_local_moves_per_global_move": "q",
               "num_parts": "i", "pop_model_type": "B"}.get(name)
        if fmt:
            out[name] = t.scalar(slot, fmt, 0)
        elif name.endswith("_enabled") or name in (
                "only_displacing_inner_nodes",):
            out[name] = bool(t.scalar(slot, "B", 0))
        else:
            out[name] = t.scalar(slot, "d", 0.0)
    out["nu"] = np.asarray(t.vector(_P["nu"], np.float64, 8))
    pm = t.table(_P["pop_model"])
    if pm is not None and out["pop_model_type"] == POP_MODEL_EXP:
        out["pop_model"] = dict(kind="exp", t0=pm.scalar(0, "d", 0.0),
                                n0=pm.scalar(1, "d", 0.0),
                                g=pm.scalar(2, "d", 0.0),
                                min_pop=pm.scalar(3, "d", 0.0))
    elif pm is not None and out["pop_model_type"] == POP_MODEL_SKYGRID:
        out["pop_model"] = dict(kind="skygrid", type=pm.scalar(0, "b", 1),
                                x=np.asarray(pm.vector(1, np.float64, 8)),
                                gamma=np.asarray(pm.vector(2, np.float64, 8)))
    else:
        out["pop_model"] = dict(kind="exp", t0=out["pop_t0"],
                                n0=out["pop_n0"], g=out["pop_g"], min_pop=0.0)
    return out


# ---------------------------------------------------------------------------
# stream reader
# ---------------------------------------------------------------------------

class DphyFile:
    """Parsed .dphy stream: preamble + per-sample (FlatTree, params dict)."""

    def __init__(self, preamble: dict, names, uncertain, samples):
        self.preamble = preamble
        self.names = names
        self.uncertain = uncertain
        self.samples = samples      # list of (FlatTree, params_dict)


def read_dphy(path) -> DphyFile:
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != MAGIC:
        raise ValueError("not a .dphy file (bad magic)")
    ver = struct.unpack_from("<I", data, 4)[0]
    if ver != 3:
        raise ValueError(f"unsupported .dphy version {ver}")
    pos = 8

    def u32():
        nonlocal pos
        v = struct.unpack_from("<I", data, pos)[0]
        pos += 4
        return v

    def f32():
        nonlocal pos
        v = struct.unpack_from("<f", data, pos)[0]
        pos += 4
        return v

    def s():
        nonlocal pos
        n = u32()
        v = data[pos:pos + n].decode("utf-8")
        pos += n
        return v

    pre = {}
    pre["core_version"] = s()
    pre["build"] = u32()
    pre["commit"] = s()
    pre["knee_index"] = u32()
    pre["steps_per_sample"] = u32()
    pre["alpha_move_enabled"] = bool(u32())
    pre["mpox_hack_enabled"] = bool(u32())
    pre["mu_move_enabled"] = bool(u32())
    pre["mu"] = f32()
    n_info = u32()
    names, uncertain = parse_tree_info_fb(data[pos:pos + n_info])
    pos += n_info

    samples = []
    while True:
        l1 = u32()
        if l1 == 0:
            break
        l2 = u32()
        tree = parse_tree_fb(data[pos:pos + l1], names=names)
        pos += l1
        params = parse_params_fb(data[pos:pos + l2])
        pos += l2
        for node, (tmin, tmax) in uncertain.items():
            tree.t_min[node] = tmin
            tree.t_max[node] = tmax
        samples.append((tree, params))
    pre["metadata_json"] = json.loads(s()) if data[pos:pos + 4] else None
    return DphyFile(pre, names, uncertain, samples)
