"""Check XLA's `jax.lax.ragged_all_to_all` against its documented semantics
on four GPUs, from the smallest call up to the shuffle engine's program.

    python benchmarks/ragged_a2a_check.py          # needs 4 GPUs

`render_hits_shuffle` exchanges its rays with a padded dense all_to_all
(`parallel/dist._exchange_blocks`).  This script runs the same exchanges
through XLA's ragged collective, which sends only the live rows:

1. synthetic: coded int32 / f32 operands, random and equal slice sizes, one
   empty slice, rank 1 and rank 2 (C = 6, 8, 9), offsets passed in;
2. offsets: the shuffle's own slice sizes (`dist._shuffle_plan` over the
   999,698-triangle terrain, chip_smoke.py's 4096-ray batch and 512²
   frame), passed in as arguments;
3. in-program: the same plan computed inside the exchanging program, one
   way and there and back;
4. engine: `render_hits_shuffle` with the ragged collective in place of the
   padded one, against the one-card trace, timed beside the padded one.

The expected output is computed on the host from `ragged_all_to_all`'s
docstring: device ``src`` sends
``operand[input_offsets[j] : input_offsets[j] + send_sizes[j]]`` to device
``j``, where it lands at ``output_offsets[j]`` of j's buffer; rows nobody
writes keep ``output``'s value.  Coded rows (source device, source row,
column) locate a slice that went astray.

Step 4 runs again in a second process with XLA's one-shot intra-host kernel
off (the processes run one after another: one JAX process per card at a
time).  Lines go to stdout; ``--out PATH`` also writes the full report as
JSON.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from functools import partial

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

S = 4
VARIANTS = {
    "default": "",
    "no_one_shot": "--xla_gpu_unsupported_use_ragged_all_to_all_one_shot_kernel=false",
}


def expected(op, out, sizes):
    """Host model of the documented semantics over global (S, K, ...)
    arrays, in the shuffle's compact layout for sizes[src, dst]."""
    in_off, out_off = layout(sizes)
    res = out.copy()
    for src in range(S):
        for dst in range(S):
            n = int(sizes[src, dst])
            o, i = int(out_off[src, dst]), int(in_off[src, dst])
            res[dst, o:o + n] = op[src, i:i + n]
    return res


def coded(K, C):
    """int32 operand: value = ((src << 20) | row) * 16 + column."""
    import numpy as np

    src = np.arange(S, dtype=np.int64)[:, None, None]
    row = np.arange(K, dtype=np.int64)[None, :, None]
    col = np.arange(C, dtype=np.int64)[None, None, :]
    return (((src << 20) | row) * 16 + col).astype(np.int32)


def layout(sizes):
    """(input_offsets, output_offsets)[src, dst] of the compact layout."""
    import numpy as np

    in_off = np.cumsum(sizes, axis=1) - sizes     # src's block for dst
    out_off = np.cumsum(sizes, axis=0) - sizes    # src's block in dst's buffer
    return in_off.astype(np.int32), out_off.astype(np.int32)


def ragged(op, out, in_off, send_sizes, out_off, axis_name="tp"):
    """`dist._exchange_blocks`'s signature on XLA's ragged collective."""
    import jax

    recv_sizes = jax.lax.all_to_all(send_sizes, axis_name, 0, 0)
    return jax.lax.ragged_all_to_all(
        op, out, in_off, send_sizes, out_off, recv_sizes, axis_name=axis_name
    )


def compare(name, got, want, op, sizes):
    """Per-slice comparison; a wrong slice is looked for by its first row."""
    import numpy as np

    in_off, out_off = layout(sizes)
    wrong, rows_wrong, detail = 0, 0, []
    for src in range(S):
        for dst in range(S):
            n, o = int(sizes[src, dst]), int(out_off[src, dst])
            if n == 0:
                continue
            bad = int(np.sum(np.any(
                (got[dst, o:o + n] != want[dst, o:o + n]).reshape(n, -1), axis=1
            )))
            if bad:
                wrong += 1
                rows_wrong += bad
                first = op[src, int(in_off[src, dst])].reshape(-1)[0]
                at = np.flatnonzero(got[dst].reshape(got.shape[1], -1)[:, 0] == first)
                detail.append({"src": src, "dst": dst, "size": n, "rows_wrong": bad,
                               "offset": o, "landed_at": int(at[0]) if at.size else -1})
    return {"case": name, "ok": bool(np.array_equal(got, want)),
            "slices": int(np.sum(sizes > 0)), "slices_wrong": wrong,
            "rows_wrong": rows_wrong, "detail": detail[:6]}


def passed_in(mesh, name, op, sizes, fill=-1, build_out=False):
    """Steps 1 and 2: the collective alone, every argument an input."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as P

    in_off, out_off = layout(sizes)
    out = np.full_like(op, fill)

    @jax.jit
    @partial(jax.shard_map, mesh=mesh, in_specs=(P("tp"),) * 5, out_specs=P("tp"),
             check_vma=False)
    def f(op, out, io, ss, oo):
        buf = jnp.full_like(out[0], fill) if build_out else out[0]
        return ragged(op[0], buf, io[0], ss[0], oo[0])[None]

    got = np.asarray(f(op, out, in_off, sizes, out_off))
    return compare(name, got, expected(op, out, sizes), op, sizes)


def synthetic(mesh):
    import numpy as np

    R = 1000
    K = S * R
    rng = np.random.default_rng(0)
    rand = rng.integers(0, R + 1, size=(S, S)).astype(np.int32)
    rand[0, 1] = 0  # an empty slice
    full = np.full((S, S), R, np.int32)
    c6 = coded(K, 6)
    return [
        passed_in(mesh, "int32 (K,6) random sizes", c6, rand),
        passed_in(mesh, "int32 (K,6) equal sizes", c6, full),
        passed_in(mesh, "int32 (K,6) output built in the program", c6, rand, build_out=True),
        passed_in(mesh, "int32 (K,) rank 1", coded(K, 1)[..., 0], rand),
        passed_in(mesh, "int32 (K,8)", coded(K, 8), rand),
        passed_in(mesh, "int32 (K,9)", coded(K, 9), rand),
        passed_in(mesh, "float32 (K,6)", coded(K, 6).astype(np.float32), rand, fill=-1.0),
    ]


def scene_and_rays():
    """chip_smoke.py's four-card scene and rays: the skewed 4096-ray batch
    and the 512² camera frame (tile-major)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import unitysimpleraytracing as rt
    from unitysimpleraytracing.core.camera import generate_rays
    from unitysimpleraytracing.ops.dispatch import _tile_major
    from unitysimpleraytracing.parallel import dist

    scene = rt.build_scene(rt.terrain_mesh(res=708, size=300.0, amplitude=30.0, seed=0))
    ss = dist.partition_scene(scene, S)
    rng = np.random.default_rng(5)
    o = rng.uniform(-150.0, 150.0, size=(4096, 3)).astype(np.float32)
    o[:2048, [0, 2]] = rng.uniform(0.0, 150.0, size=(2048, 2))
    o[:, 1] = 100.0
    d = rng.normal(size=(4096, 3)).astype(np.float32)
    d[:, 1] = -np.abs(d[:, 1]) - 0.3
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    cam = rt.make_camera(eye=(210.0, 160.0, 260.0), target=(0.0, 0.0, 0.0),
                         width=512, height=512, fov_deg=60.0)

    def tiled():
        co, cd = generate_rays(cam)
        return _tile_major(co, 512, 512, 32), _tile_major(cd, 512, 512, 32)

    rays = {"batch4096": (jnp.asarray(o), jnp.asarray(d)), "frame512": jax.jit(tiled)()}
    return scene, ss, rays


def in_program(mesh, ss, o, d, roundtrip):
    """Step 3: plan and exchange in one program; returns (got, sizes)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as P

    from unitysimpleraytracing.parallel import dist

    @jax.jit
    @partial(jax.shard_map, mesh=mesh, in_specs=(P(), P(), P("tp"), P("tp")),
             out_specs=P("tp"), check_vma=False)
    def inprogram_exchange(rmin, rmax, o, d):
        _, _, send, fwd, rev = dist._shuffle_plan(o, d, rmin, rmax)
        K = send.shape[0]
        me = jax.lax.axis_index("tp").astype(jnp.int32)
        rows = jnp.arange(K, dtype=jnp.int32)
        op = ((me << 20) | rows)[:, None] * 16 + jnp.arange(6, dtype=jnp.int32)[None, :]
        got = ragged(op, jnp.full_like(op, -1), *fwd)
        if roundtrip:
            got = ragged(got, jnp.full_like(op, -1), *rev)
        return got[None], fwd[1][None]

    got, sizes = inprogram_exchange(ss.range_min, ss.range_max, o, d)
    return np.asarray(got), np.asarray(sizes)


def _median_ms(fn, reps=10):
    import jax
    import numpy as np

    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def engine(mesh, scene, ss, rays, labels):
    """Step 4: `render_hits_shuffle` with each exchange, vs the one-card trace."""
    import jax
    import numpy as np

    import unitysimpleraytracing as rt
    from unitysimpleraytracing import constants as C
    from unitysimpleraytracing.ops import dispatch
    from unitysimpleraytracing.parallel import dist

    exchanges = {"shuffle_padded": dist._exchange_blocks, "shuffle_ragged": ragged}
    bvh = rt.build_bvh(scene, builder="karras")
    rows = []
    for bname, (o, d) in rays.items():
        ref = dispatch.trace_rays(scene, bvh, o, d)
        rt_, rtri = np.asarray(ref.t), np.asarray(ref.tri)
        for label in labels:
            saved = dist._exchange_blocks
            dist._exchange_blocks = exchanges[label]
            try:
                step = jax.jit(lambda s_, o_, d_: dist.render_hits_shuffle(s_, o_, d_, mesh)[:2])
                ms = _median_ms(lambda: step(ss, o, d))
                t, tri = (np.asarray(x) for x in step(ss, o, d))
            finally:
                dist._exchange_blocks = saved
            hit, rhit = t != C.MAX_FLOAT, rt_ != C.MAX_FLOAT
            rows.append({"batch": bname, "engine": label, "steady_ms": ms,
                         "hits": int(rhit.sum()), "mask_diff": int(np.sum(hit != rhit)),
                         "t_diff": int(np.sum((t != rt_) & rhit)),
                         "tri_diff": int(np.sum((tri != rtri) & rhit))})
    return rows


def child(variant):
    import jax
    import numpy as np

    from unitysimpleraytracing.parallel import dist
    from unitysimpleraytracing.utils import compile_cache

    compile_cache.enable()
    devs = jax.devices()
    assert devs[0].platform == "gpu" and len(devs) >= S, f"needs {S} GPUs: {devs}"
    mesh = dist.make_mesh(dp=1, tp=S)
    rep = {"variant": variant, "xla_flags": os.environ.get("XLA_FLAGS", ""), "cases": []}
    scene, ss, rays = scene_and_rays()
    if variant == "default":
        rep["cases"] += synthetic(mesh)
        for bname, (o, d) in rays.items():
            fwd, sizes = in_program(mesh, ss, o, d, roundtrip=False)
            back, _ = in_program(mesh, ss, o, d, roundtrip=True)
            K = fwd.shape[1]
            op = coded(K, 6)
            fill = np.full_like(op, -1)
            back_sizes = np.ascontiguousarray(sizes.T)
            want_fwd = expected(op, fill, sizes)
            want_back = expected(want_fwd, fill, back_sizes)
            rep[f"sizes_{bname}"] = sizes.tolist()
            rep["cases"] += [
                passed_in(mesh, f"offsets {bname} forward (K={K},6)", op, sizes),
                passed_in(mesh, f"offsets {bname} reverse (K={K},9)", coded(K, 9), back_sizes),
                compare(f"in-program {bname} forward", fwd, want_fwd, op, sizes),
                compare(f"in-program {bname} there and back", back, want_back,
                        want_fwd, back_sizes),
            ]
    rep["engine"] = engine(mesh, scene, ss, rays, ["shuffle_ragged"])
    print("REPORT " + json.dumps(rep), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--child", choices=sorted(VARIANTS), help=argparse.SUPPRESS)
    ap.add_argument("--out", help="write the full report here as JSON")
    args = ap.parse_args(argv)
    if args.child:
        child(args.child)
        return 0

    reports = []
    for variant, flags in VARIANTS.items():
        env = dict(os.environ)
        env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " " + flags).strip()
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", variant],
                              env=env, capture_output=True, text=True, timeout=600)
        line = [ln for ln in proc.stdout.splitlines() if ln.startswith("REPORT ")]
        rep = (json.loads(line[-1][7:]) if line else
               {"variant": variant, "rc": proc.returncode, "stderr": proc.stderr[-3000:]})
        reports.append(rep)
        for c in rep.get("cases", []):
            print(f"{variant} {'ok ' if c['ok'] else 'BAD'} {c['case']}: "
                  f"slices_wrong={c['slices_wrong']}/{c['slices']} rows_wrong={c['rows_wrong']}"
                  + (f" first={c['detail'][0]}" if c["detail"] else ""), flush=True)
        for r in rep.get("engine", []):
            print(f"{variant} engine {r}", flush=True)
        if "stderr" in rep:
            print(f"{variant} rc={rep['rc']} {rep['stderr']}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(reports, f, indent=1)
    print(json.dumps({
        "collective_matches_docs": all(c["ok"] for r in reports for c in r.get("cases", [])),
        "engine_exact": all(e["mask_diff"] == 0 for r in reports for e in r.get("engine", [])),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
