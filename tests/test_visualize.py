"""Gizmo AABB wireframe overlay (the RaytracingMeshDrawer.cs:92-116 analog)."""
import numpy as np

import unitysimpleraytracing as rt
from unitysimpleraytracing.utils import visualize


def test_aabb_overlay_draws_green_edges():
    mesh = rt.cube_mesh(size=2.0)
    scene = rt.build_scene(mesh)
    bvh = rt.build_bvh(scene)
    cam = rt.make_camera(eye=(3, 2.5, 4), target=(0, 0, 0), width=128, height=96)
    frame = np.zeros((96, 128, 4), np.float32)
    out = visualize.draw_aabbs(
        frame, cam,
        np.asarray(bvh.node_aabb_min)[: bvh.num_internal],
        np.asarray(bvh.node_aabb_max)[: bvh.num_internal],
    )
    assert frame.sum() == 0  # input not mutated
    green = (out[:, :, 1] == 1.0) & (out[:, :, 0] == 0.0)
    assert green.sum() > 50  # wireframe pixels present
    # Cube center projects inside the drawn bounding region.
    x, y, vis = visualize.project_points(cam, np.zeros((1, 3), np.float32))
    assert vis[0] and 0 < x[0] < 128 and 0 < y[0] < 96
    ys, xs = np.nonzero(green)
    assert xs.min() < x[0] < xs.max() and ys.min() < y[0] < ys.max()


def test_points_behind_camera_are_culled():
    cam = rt.make_camera(eye=(0, 0, 0), target=(0, 0, -1), width=64, height=64)
    pts = np.array([[0, 0, -5], [0, 0, 5]], np.float32)  # in front, behind
    _, _, vis = visualize.project_points(cam, pts)
    assert vis[0] and not vis[1]
