"""The benchmark's scene: the synthetic room of ``datasets/synthetic.py``
(the "spheres" archetype) and its orbit, ray-cast on the card.

A frozen copy of ``SyntheticDataset._raycast`` and of its orbit, in torch,
so a whole 960-frame lap at 640x480 is cast in a few large calls on the
device instead of frame by frame on the host. Frames are quantised as a
sensor delivers them (8-bit colour, millimetre depth), so a frame served
from memory equals the same frame written to and read back from a PNG.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SPHERE_CENTRES = ((0.0, 0.0, 0.0), (1.2, 0.4, -0.6), (-1.0, -0.3, 0.8))
SPHERE_RADII = (0.6, 0.45, 0.5)
SPHERE_COLOURS = ((0.9, 0.2, 0.2), (0.2, 0.9, 0.3), (0.25, 0.35, 0.95))


def look_at(eye: np.ndarray) -> np.ndarray:
    """OpenGL c2w looking from ``eye`` at the origin, y up (camera along -z)."""
    fwd = -eye / np.linalg.norm(eye)
    right = np.cross(fwd, np.array([0.0, 1.0, 0.0], np.float32))
    right = right / np.linalg.norm(right)
    up = np.cross(right, fwd)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, up, -fwd, eye
    return c2w


def orbit(lap_frames: int, radius: float) -> np.ndarray:
    """(lap_frames, 4, 4) poses of the orbit: once round the room, bobbing
    twice in height, as ``SyntheticDataset`` moves its camera."""
    poses = []
    for i in range(lap_frames):
        a = 2 * math.pi * i / lap_frames
        eye = np.array([radius * np.cos(a), 0.6 * np.sin(2 * a), radius * np.sin(a)], np.float32)
        poses.append(look_at(eye))
    return np.stack(poses)


def directions(width: int, height: int, fx: float, fy: float, device) -> torch.Tensor:
    """(H * W, 3) unit ray directions in the camera frame (OpenGL), principal
    point at the image centre, pixel centres at integer coordinates."""
    ii, jj = torch.meshgrid(torch.arange(height, device=device, dtype=torch.float32),
                            torch.arange(width, device=device, dtype=torch.float32), indexing="ij")
    d = torch.stack([(jj - width / 2.0) / fx, -(ii - height / 2.0) / fy, -torch.ones_like(ii)], -1)
    return (d / torch.linalg.norm(d, dim=-1, keepdim=True)).reshape(-1, 3)


def raycast(c2ws: torch.Tensor, dirs: torch.Tensor, room_half: float) -> torch.Tensor:
    """(B, 4, 4) poses -> (B, H * W, 4) RGB-D (z-depth in metres): three
    shaded spheres in a box room with checkered walls."""
    dev = dirs.device
    dirs_w = torch.einsum("pj,bij->bpi", dirs, c2ws[:, :3, :3])  # (B, P, 3)
    origin = c2ws[:, None, :3, 3]  # (B, 1, 3)
    b, p = dirs_w.shape[:2]
    t_best = torch.full((b, p), math.inf, device=dev)
    colour = torch.zeros((b, p, 3), device=dev)
    for ctr, r, col in zip(SPHERE_CENTRES, SPHERE_RADII, SPHERE_COLOURS):
        oc = origin - torch.tensor(ctr, device=dev)
        bq = torch.sum(dirs_w * oc, -1)
        disc = bq * bq - (torch.sum(oc * oc, -1) - r * r)
        t = -bq - torch.sqrt(torch.clamp(disc, min=0.0))
        ok = (disc > 0) & (t > 0.05) & (t < t_best)
        normal_y = (origin[..., 1] + dirs_w[..., 1] * t - ctr[1]) / r
        shade = 0.6 + 0.4 * torch.clamp(normal_y, -1, 1)
        colour = torch.where(ok[..., None], torch.tensor(col, device=dev) * shade[..., None], colour)
        t_best = torch.where(ok, t, t_best)
    for axis in range(3):
        others = [a for a in range(3) if a != axis]
        for sign in (-1.0, 1.0):
            denom = dirs_w[..., axis]
            t = (sign * room_half - origin[..., axis]) / denom
            t = torch.where(torch.isfinite(t), t, -1.0)
            pt = origin + dirs_w * t[..., None]
            inside = ((pt[..., others[0]].abs() <= room_half) & (pt[..., others[1]].abs() <= room_half)
                      & (t > 0.05))
            ok = inside & (t < t_best)
            checker = torch.remainder(torch.floor(pt[..., others[0]] * 2) + torch.floor(pt[..., others[1]] * 2), 2)
            wall = 0.35 + 0.3 * checker
            colour = torch.where(ok[..., None], torch.stack([wall, wall, wall * 0.9], -1), colour)
            t_best = torch.where(ok, t, t_best)
    depth = torch.where(torch.isfinite(t_best), t_best, 0.0) * (-dirs[None, :, 2])
    return torch.cat([colour, depth[..., None]], -1)


def quantise(rgbd: torch.Tensor) -> torch.Tensor:
    """RGB to 8 bits and depth to whole millimetres, as float32 again, by the
    arithmetic of the NRGBD loader (``/ 255``, ``* 0.001``)."""
    rgb = torch.clamp(torch.floor(rgbd[..., :3] * 255.0 + 0.5), 0, 255) / 255.0
    depth = torch.clamp(torch.floor(rgbd[..., 3:] * 1000.0 + 0.5), 0, 65535) * 0.001
    return torch.cat([rgb, depth], -1)


def cast_lap(scene: dict, device, indices=None, chunk: int = 32) -> tuple:
    """The lap of ``scene`` (a configuration's ``scene`` block) -> (frames
    {lap index: (H, W, 4) float32 numpy on the host}, poses (N, 4, 4));
    the frames of ``indices`` only, where given."""
    w, h = int(scene["width"]), int(scene["height"])
    poses = orbit(int(scene["lap_frames"]), float(scene["orbit_radius"]))
    dirs = directions(w, h, float(scene["fx"]), float(scene["fy"]), device)
    todo = sorted(set(range(len(poses)) if indices is None else indices))
    frames = {}
    for s in range(0, len(todo), chunk):
        ids = todo[s:s + chunk]
        c2ws = torch.from_numpy(poses[ids]).to(device)
        cast = quantise(raycast(c2ws, dirs, float(scene["room_half"]))).reshape(-1, h, w, 4).cpu().numpy()
        frames.update(zip(ids, cast))
    return frames, poses
