"""GPU traversal engine: one ray per lane, a private DFS stack per ray.

The reference traces one pixel per GPU thread with a 64-entry private stack
(``Raytracing.compute:105-176``).  This engine keeps that SIMT design and
compiles through Pallas's Triton route: a program owns ``BLOCK`` rays (one
warp), and every lane walks its own ray through the tree.

Records are the wide BVH4 form: the internal Karras nodes at EVEN depth,
each holding its (up to) four grandchildren as entries, so one record fetch
advances a ray two tree levels.

- **Record = 64 f32 slots** (256 B): 4 entry boxes (slots 0-23), 4 metas
  (24-27), and 4 embedded leaf triangles stored pre-differenced as
  (a, e1=b−a, e2=c−a) (28-63).  The f32 subtraction moves from the kernel
  to pack time bit-unchanged, so hit parity with the reference is exact.
- **Meta slot** (f32-exact, < 2^24): ``idx + is_leaf<<21 + axis<<22`` where
  idx is the entry's record id (internal) or triangle id (leaf).  meta0's
  axis is the record's own split axis (orders the two pairs), meta1/meta2's
  axes are its BVH2 children's split axes (order within each pair).  Ids
  must stay below 2^21 (`MAX_IDS`): that is the engine's capacity bound.
- Absent entries are inert: inverted box (the slab test always fails), leaf
  bit set, zero vertices.

Traversal per lane: test the four entry boxes, run Möller–Trumbore on the
leaf entries that pass, descend into the nearest internal entry that passes
and push the others far-first; pop when nothing passes.  The descent order
is the reference's near-child order along the split axes, per ray; the
strict-< keep makes order matter only at exact-t ties.

Acceptance is the reference's (Raytracing.compute:37-103): slab
``tmax>tmin && tmax>0`` (plus the exact ``tmin < t`` cull), det∈(−1e-8,1e-8)
reject, no t>0 test, strict-< nearest hit, miss ⇒ t=MAX_FLOAT, tri=0.
Divisions are IEEE round-to-nearest (PTX ``div.rn.f32``) so the arithmetic
matches XLA's, and min/max follow the D3D NaN rule (PTX ``min``/``max``
return the non-NaN operand; the interpreter path uses the explicit form).
"""
from __future__ import annotations

import functools
import weakref

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from unitysimpleraytracing import constants as C
from unitysimpleraytracing.core.types import Bvh, HitRecord, Scene
from unitysimpleraytracing.ops import lbvh
from unitysimpleraytracing.ops.intersect import d3d_max, d3d_min

SLOTS = 64
MAX_IDS = 1 << 21  # meta id field: record and triangle ids must stay below
# Rays per program: one warp, one ray per lane.  Measured against 64 and
# 128 rays with 1-4 warps on the H100 (PERF.md): 32/1 had the least device
# time at 65K/512² and at 260K/1920×1056.
BLOCK = 32
NUM_WARPS = 1
# Per-ray stack: near-child descent pushes at most 3 entries per BVH4 level,
# so 128 entries cover trees 42 BVH4 (84 binary) levels deep.
STACK_DEPTH = 2 * C.TRAVERSAL_STACK_DEPTH
# The stacks live in a scratch output of rays × STACK_DEPTH int32; calls are
# split so it stays at 256 MB.
MAX_RAYS_PER_CALL = 1 << 19


class CapacityError(ValueError):
    """Scene exceeds the GPU engine's record-id bound (`MAX_IDS`)."""


def check_capacity(capacity: int) -> None:
    """Raise `CapacityError` when a scene's ids do not fit the meta field.
    Even-depth records number ≤ (2n+1)/3 < n, so the triangle bound binds."""
    if capacity >= MAX_IDS:
        raise CapacityError(
            f"scene capacity {capacity} reaches the traversal engine's id "
            f"bound ({MAX_IDS} triangles: record metas pack ids in 21 bits). "
            f"Use build_bvh_chunked + render_frame_chunked/trace_chunked, "
            f"or request impl='perray' explicitly."
        )


# ---------------------------------------------------------------------------
# Record tables
# ---------------------------------------------------------------------------

# id(bvh.left) -> (weakref(left), mask, new_id, count, plans).  Keyed by the
# TOPOLOGY array's identity: refit_bvh replaces only the box fields, so a
# refit-per-frame loop reuses the even-depth membership and the pack plan.
_TOPO_CACHE: dict = {}


def _node_mask_compute(bvh: Bvh):
    cap = bvh.left.shape[0]
    ids = jnp.arange(cap, dtype=jnp.int32)
    valid = ids < bvh.count - 1
    # Parent links may be absent (-1-filled non-diagnostic build): recompute.
    drop = jnp.int32(cap)
    iparent = jnp.full(cap, -1, jnp.int32)
    li = jnp.where(valid & ~bvh.left_is_leaf, bvh.left, drop)
    ri = jnp.where(valid & ~bvh.right_is_leaf, bvh.right, drop)
    iparent = iparent.at[li].set(ids, mode="drop")
    iparent = iparent.at[ri].set(ids, mode="drop")
    depth = lbvh.compute_depths(iparent, bvh.count)
    mask = valid & (depth % 2 == 0)
    new_id = jnp.cumsum(mask.astype(jnp.int32)) - 1
    return mask, new_id


def _is_traced(x) -> bool:
    return isinstance(jnp.asarray(x), jax.core.Tracer)


def node_mask(bvh: Bvh):
    """(mask, new_id, count|None): even-depth internal nodes, their record
    ids, and the host record count (concrete inputs only; cached per
    topology, since reading it costs a device→host sync)."""
    if _is_traced(bvh.left):
        mask, new_id = _node_mask_compute(bvh)
        return mask, new_id, None
    key = id(bvh.left)
    ent = _TOPO_CACHE.get(key)
    if ent is not None and ent[0]() is bvh.left:
        return ent[1], ent[2], ent[3]
    mask, new_id = jax.jit(_node_mask_compute)(bvh)
    count = int(jnp.sum(mask))
    try:
        ref = weakref.ref(bvh.left, lambda _r, _k=key: _TOPO_CACHE.pop(_k, None))
        _TOPO_CACHE[key] = (ref, mask, new_id, count, {})
    except TypeError:
        pass
    return mask, new_id, count


@functools.partial(jax.jit, static_argnames=("cap4",))
def pack_plan(bvh: Bvh, mask, new_id, cap4: int):
    """Topology-only half of the table pack: per-record entry SOURCE rows
    into `apply_plan`'s geometry array, plus the constant meta columns.
    A deforming mesh keeps its tree (refit_bvh keeps the child links), so
    the plan is computed once per topology."""
    cap = bvh.capacity

    Lc = jnp.clip(bvh.left, 0, cap - 1)
    Rc = jnp.clip(bvh.right, 0, cap - 1)
    Ll, Rl = bvh.left_is_leaf, bvh.right_is_leaf

    def grand(c):
        gl = jnp.clip(bvh.left[c], 0, cap - 1)
        gr = jnp.clip(bvh.right[c], 0, cap - 1)
        return gl, bvh.left_is_leaf[c], gr, bvh.right_is_leaf[c]

    LL, LLl, LR, LRl = grand(Lc)
    RL, RLl, RR, RRl = grand(Rc)

    def entry(node2, is_leaf, present):
        """Source row + meta fields for one entry: leaf entries read row
        cap+tri (triangle geometry), internal entries read row node2 (node
        boxes), absent entries read the inert EMPTY row 2·cap."""
        tri = bvh.sorted_tri[node2]
        src = jnp.where(is_leaf, cap + tri, node2)
        src = jnp.where(present, src, 2 * cap)
        idx = jnp.where(is_leaf, tri, new_id[node2])
        idx = jnp.where(present, idx, 0)
        leaf_bit = jnp.where(present, is_leaf.astype(jnp.int32), 1)
        return src, idx, leaf_bit

    true_ = jnp.ones((cap,), bool)
    e0 = entry(jnp.where(Ll, Lc, LL), jnp.where(Ll, True, LLl), true_)
    e1 = entry(LR, LRl, ~Ll)
    e2 = entry(jnp.where(Rl, Rc, RL), jnp.where(Rl, True, RLl), true_)
    e3 = entry(RR, RRl, ~Rl)

    # Near-child ordering axes: record's own split axis + each pair's axis.
    ax_self = jnp.clip(bvh.split_axis, 0, 2)
    ax_l = jnp.where(Ll, 0, jnp.clip(bvh.split_axis[Lc], 0, 2))
    ax_r = jnp.where(Rl, 0, jnp.clip(bvh.split_axis[Rc], 0, 2))
    axes = (ax_self, ax_l, ax_r, jnp.zeros((cap,), jnp.int32))

    srcs = jnp.stack([e[0] for e in (e0, e1, e2, e3)], axis=1)  # (cap, 4)
    metas = jnp.stack(
        [
            (e[1] + (e[2] << 21) + (ax << 22)).astype(jnp.float32)
            for e, ax in zip((e0, e1, e2, e3), axes)
        ],
        axis=1,
    )  # (cap, 4)

    # Compact mask rows to their record ids (record r reads BVH2 node
    # rows[r]); padding rows replicate node 0's entries — never referenced.
    ids = jnp.arange(cap, dtype=jnp.int32)
    rows = jnp.zeros((cap4,), jnp.int32).at[
        jnp.where(mask, new_id, cap4)
    ].set(ids, mode="drop")
    return srcs[rows], metas[rows]  # (cap4, 4) each


@jax.jit
def apply_plan(scene: Scene, bvh: Bvh, src_idx, metas):
    """Geometry-only half of the table pack: gather each entry's 15 slots
    (6 box + 9 pre-differenced verts) by the plan's source rows."""
    cap = bvh.capacity
    t = scene.triangles
    BIG = jnp.float32(3.0e38)
    zeros9 = jnp.zeros((cap, 9), jnp.float32)
    # Rows [0, cap): internal BVH2 nodes (boxes; verts inert zeros).
    # Rows [cap, 2cap): triangles (leaf box + (a, e1=b−a, e2=c−a)).
    # Row 2cap: the inert EMPTY entry (inverted box, zero verts).
    S = jnp.concatenate(
        [
            jnp.concatenate([bvh.node_aabb_min, bvh.node_aabb_max, zeros9], axis=1),
            jnp.concatenate(
                [scene.aabb_min, scene.aabb_max, t.a, t.b - t.a, t.c - t.a], axis=1
            ),
            jnp.concatenate(
                [jnp.full((1, 3), BIG), jnp.full((1, 3), -BIG),
                 jnp.zeros((1, 9), jnp.float32)],
                axis=1,
            ),
        ],
        axis=0,
    )  # (2·cap + 1, 15)

    # Cull-margin widening: the exact ``tmin < t`` cull leans on the 1e-3
    # AABB inflation dominating slab rounding, which holds to scene extents
    # of ~8e3; beyond that the stored boxes widen in proportion.
    root = jnp.maximum(
        jnp.max(jnp.abs(bvh.node_aabb_min[0])), jnp.max(jnp.abs(bvh.node_aabb_max[0]))
    )
    widen = jnp.maximum(root - 8192.0, 0.0) * 4e-6

    g = [S[src_idx[:, e]] for e in range(4)]  # 4 × (cap4, 15)
    return jnp.concatenate(
        [jnp.concatenate([ge[:, 0:3] - widen, ge[:, 3:6] + widen], axis=1)
         for ge in g]
        + [metas]
        + [ge[:, 6:15] for ge in g],
        axis=1,
    )  # (cap4, 64): boxes 0-23, metas 24-27, verts 28-63


def worst_case_records(capacity: int) -> int:
    """Static record count for traced trees: ≤ (2n+1)/3 even-depth nodes."""
    return (2 * capacity) // 3 + 2


def pack_tables(scene: Scene, bvh: Bvh, cap4: int | None = None, mask=None,
                new_id=None):
    """Flatten scene+BVH into the (cap4, 64) record table (module doc).

    ``cap4`` is the static record count (defaults to the worst case);
    ``mask``/``new_id`` optionally carry a `node_mask` result."""
    check_capacity(bvh.capacity)
    if cap4 is None:
        cap4 = worst_case_records(bvh.capacity)
    if mask is None:
        mask, new_id, _ = node_mask(bvh)
    plan = None
    if not _is_traced(bvh.left):
        ent = _TOPO_CACHE.get(id(bvh.left))
        if ent is not None and ent[0]() is bvh.left:
            plan = ent[4].get(cap4)
            if plan is None:
                plan = pack_plan(bvh, mask, new_id, cap4)
                ent[4][cap4] = plan
    if plan is None:
        plan = pack_plan(bvh, mask, new_id, cap4)
    return apply_plan(scene, bvh, *plan)


# id(bvh) -> (weakref(bvh), weakref(scene), tables)
_TABLE_CACHE: dict = {}


def prepare_tables(scene: Scene, bvh: Bvh):
    """Record table for (scene, bvh), cached per Bvh instance and sized to
    the ACTUAL record count (one host read).  Inside a jit trace the
    worst-case count is used."""
    if _is_traced(bvh.left):
        return pack_tables(scene, bvh)
    key = id(bvh)
    ent = _TABLE_CACHE.get(key)
    if ent is not None and ent[0]() is bvh and ent[1]() is scene:
        return ent[2]
    mask, new_id, cap4 = node_mask(bvh)
    tables = pack_tables(scene, bvh, cap4=max(cap4, 1), mask=mask, new_id=new_id)
    try:
        bvh_ref = weakref.ref(bvh, lambda _r, _k=key: _TABLE_CACHE.pop(_k, None))
        scene_ref = weakref.ref(scene)
    except TypeError:
        return tables
    _TABLE_CACHE[key] = (bvh_ref, scene_ref, tables)
    return tables


# ---------------------------------------------------------------------------
# Kernel
# ---------------------------------------------------------------------------


def _kernel(nodes_ref, rays_ref, t_ref, tri_ref, u_ref, v_ref, stack_ref, *,
            interpret: bool):
    block, depth = BLOCK, STACK_DEPTH
    if interpret:
        fmin, fmax = d3d_min, d3d_max

        def fdiv(a, b):
            return a / b
    else:
        # PTX min/max already return the non-NaN operand (the D3D rule).
        fmin, fmax = jnp.minimum, jnp.maximum

        def fdiv(a, b):
            a = jnp.broadcast_to(a, b.shape).astype(jnp.float32)
            return plgpu.elementwise_inline_asm(
                "div.rn.f32 $0, $1, $2;", args=[a, b], constraints="=f,f,f",
                pack=1, result_shape_dtypes=[jax.ShapeDtypeStruct(b.shape, b.dtype)],
            )[0]

    lane = jax.lax.broadcasted_iota(jnp.int32, (block,), 0)
    ox, oy, oz = rays_ref[0], rays_ref[1], rays_ref[2]
    dx, dy, dz = rays_ref[3], rays_ref[4], rays_ref[5]
    t_init, thr = rays_ref[6], rays_ref[7]
    one = jnp.ones((block,), jnp.float32)
    ix, iy, iz = fdiv(one, dx), fdiv(one, dy), fdiv(one, dz)
    pos = (dx >= 0, dy >= 0, dz >= 0)

    def left_first(ax):
        """Per ray: is the lower (left) side of a split along ``ax`` nearer?"""
        return jnp.where(ax == 0, pos[0], jnp.where(ax == 1, pos[1], pos[2]))

    def slab(b, t_cur):
        t1x, t2x = (b[0] - ox) * ix, (b[3] - ox) * ix
        t1y, t2y = (b[1] - oy) * iy, (b[4] - oy) * iy
        t1z, t2z = (b[2] - oz) * iz, (b[5] - oz) * iz
        tmin = fmax(fmin(t1x, t2x), fmax(fmin(t1y, t2y), fmin(t1z, t2z)))
        tmax = fmin(fmax(t1x, t2x), fmin(fmax(t1y, t2y), fmax(t1z, t2z)))
        return (tmax > tmin) & (tmax > 0) & (tmin < t_cur)

    def leaf_test(tri_idx, verts, gate, state):
        t_cur, tri_cur, u_cur, v_cur = state
        ax, ay, az, e1x, e1y, e1z, e2x, e2y, e2z = verts
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = e1x * px + e1y * py + e1z * pz
        inv_det = fdiv(one, det)
        tvx, tvy, tvz = ox - ax, oy - ay, oz - az
        u = (tvx * px + tvy * py + tvz * pz) * inv_det
        qx = tvy * e1z - tvz * e1y
        qy = tvz * e1x - tvx * e1z
        qz = tvx * e1y - tvy * e1x
        v = (dx * qx + dy * qy + dz * qz) * inv_det
        t_new = (e2x * qx + e2y * qy + e2z * qz) * inv_det
        reject = (
            ((det < 1e-8) & (det > -1e-8))
            | ((u < 0) | (u > 1))
            | ((v < 0) | (u + v > 1))
        )
        accept = gate & ~reject & (t_new < t_cur)
        return (
            jnp.where(accept, t_new, t_cur),
            jnp.where(accept, tri_idx, tri_cur),
            jnp.where(accept, u, u_cur),
            jnp.where(accept, v, v_cur),
        )

    def stack_slot(sp):
        return stack_ref.at[sp * block + lane]

    def body(carry):
        k, sp, active, t, tri, u, v = carry
        rec = [nodes_ref[k, c] for c in range(28)]  # boxes + metas
        hit = [active & slab(rec[6 * e:6 * e + 6], t) for e in range(4)]
        meta = [rec[24 + e].astype(jnp.int32) for e in range(4)]
        idx = [m & (MAX_IDS - 1) for m in meta]
        leaf = [((m >> 21) & 1) == 1 for m in meta]

        for e in range(4):
            gate = hit[e] & leaf[e]
            verts = [
                plgpu.load(nodes_ref.at[k, 28 + 9 * e + j], mask=gate, other=0.0)
                for j in range(9)
            ]
            t, tri, u, v = leaf_test(idx[e], verts, gate, (t, tri, u, v))

        # Any-hit: the first hit strictly below the threshold ends the ray
        # with t collapsed to 0 (occlusion only needs the boolean).
        done = (thr > 0) & (t < thr)
        t = jnp.where(done, jnp.float32(0.0), t)

        # Internal entries in near-first order: pair by the record's axis,
        # entry by the pair's axis.
        push = [hit[e] & ~leaf[e] for e in range(4)]
        nl = left_first(meta[1] >> 22)
        nr = left_first(meta[2] >> 22)
        npair = left_first(meta[0] >> 22)

        def ordered(a, b, near):
            return (
                (jnp.where(near, a[0], b[0]), jnp.where(near, a[1], b[1])),
                (jnp.where(near, b[0], a[0]), jnp.where(near, b[1], a[1])),
            )

        l0, l1 = ordered((idx[0], push[0]), (idx[1], push[1]), nl)
        r0, r1 = ordered((idx[2], push[2]), (idx[3], push[3]), nr)
        (s0, s2), (s1, s3) = ordered(l0, r0, npair), ordered(l1, r1, npair)

        # Descend into the nearest passing entry; push the farther ones
        # far-first so they pop in near order.
        live = ~done
        for ii, pp, before in (
            (s3[0], s3[1], s0[1] | s1[1] | s2[1]),
            (s2[0], s2[1], s0[1] | s1[1]),
            (s1[0], s1[1], s0[1]),
        ):
            do = live & pp & before & (sp < depth)
            plgpu.store(stack_slot(sp), ii, mask=do)
            sp = sp + do.astype(jnp.int32)
        nxt = jnp.where(
            s0[1], s0[0], jnp.where(s1[1], s1[0], jnp.where(s2[1], s2[0], s3[0]))
        )
        has = s0[1] | s1[1] | s2[1] | s3[1]
        pop = active & live & ~has & (sp > 0)
        top = jnp.maximum(sp - 1, 0)
        popped = plgpu.load(stack_slot(top), mask=pop, other=0)
        sp = jnp.where(pop, top, sp)
        k = jnp.where(has, nxt, popped)
        active = active & live & (has | pop)
        return k, sp, active, t, tri, u, v

    def cond(carry):
        return jnp.max(carry[2].astype(jnp.int32)) > 0

    zi = jnp.zeros((block,), jnp.int32)
    zf = jnp.zeros((block,), jnp.float32)
    init = (zi, zi, jnp.ones((block,), jnp.bool_), t_init, zi, zf, zf)
    _, _, _, t, tri, u, v = jax.lax.while_loop(cond, body, init)
    t_ref[...] = t
    tri_ref[...] = tri
    u_ref[...] = u
    v_ref[...] = v


@functools.lru_cache(maxsize=64)
def _traversal_fn(n_rays: int, cap4: int, interpret: bool):
    block, depth = BLOCK, STACK_DEPTH
    assert n_rays % block == 0
    n_blocks = n_rays // block
    ray_spec = pl.BlockSpec((block,), lambda i: (i,))
    call = pl.pallas_call(
        functools.partial(_kernel, interpret=interpret),
        grid=(n_blocks,),
        in_specs=[
            pl.BlockSpec((cap4, SLOTS), lambda i: (0, 0)),
            pl.BlockSpec((8, block), lambda i: (0, i)),
        ],
        out_specs=[ray_spec] * 4 + [pl.BlockSpec((depth * block,), lambda i: (i,))],
        out_shape=[
            jax.ShapeDtypeStruct((n_rays,), jnp.float32),
            jax.ShapeDtypeStruct((n_rays,), jnp.int32),
            jax.ShapeDtypeStruct((n_rays,), jnp.float32),
            jax.ShapeDtypeStruct((n_rays,), jnp.float32),
            jax.ShapeDtypeStruct((n_blocks * depth * block,), jnp.int32),
        ],
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        backend="triton",
        interpret=interpret,
        name="bvh4_traverse",
    )

    @jax.jit
    def run(nodes, rays):
        t, tri, u, v, _ = call(nodes, rays)
        return t, tri, u, v

    return run


def traverse(
    scene: Scene,
    bvh: Bvh,
    origins: jnp.ndarray,
    dirs: jnp.ndarray,
    tables=None,
    t_init: jnp.ndarray | None = None,
    anyhit_thresh: jnp.ndarray | None = None,
    interpret: bool = False,
) -> HitRecord:
    """Nearest-hit traversal of (R, 3) rays, R a multiple of `BLOCK`.

    ``tables``: a `prepare_tables` result (packed here when absent).
    ``t_init`` (R,) seeds each ray's running best — an exact prune bound
    from an earlier traversal; a candidate at or beyond it cannot win.
    ``anyhit_thresh`` (R,), 0 = off: a ray ends at its first hit strictly
    below the threshold with t collapsed to 0.  ``interpret`` runs the
    kernel in the Pallas interpreter (CPU tests)."""
    R = origins.shape[0]
    assert R % BLOCK == 0, f"{R} rays not divisible by block {BLOCK}"
    if tables is None:
        tables = prepare_tables(scene, bvh)
    cap4 = tables.shape[0]
    t_row = (
        jnp.full((R,), C.MAX_FLOAT, jnp.float32) if t_init is None else t_init
    )
    thr_row = jnp.zeros((R,), jnp.float32) if anyhit_thresh is None else anyhit_thresh
    rays = jnp.concatenate(
        [origins.T, dirs.T, t_row[None, :], thr_row[None, :]], axis=0
    ).astype(jnp.float32)  # (8, R)
    step = max(MAX_RAYS_PER_CALL // BLOCK, 1) * BLOCK
    outs = []
    for lo in range(0, R, step):
        n = min(step, R - lo)
        run = _traversal_fn(n, cap4, interpret)
        outs.append(run(tables, rays[:, lo:lo + n]))
    if len(outs) == 1:
        t, tri, u, v = outs[0]
    else:
        t, tri, u, v = (jnp.concatenate(p) for p in zip(*outs))
    return HitRecord(t=t, tri=tri, u=u, v=v)
