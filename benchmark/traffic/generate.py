"""The benchmark's one traffic generator: synthetic RGB-D scenes made on a
device from a seed, as a traffic file's parameters ask.

A traffic file (``traffic/<name>.json``) names a ``scene`` kind and its
sizes:

- ``det_room``: an 8 m room (floor and two walls, 1 cm noise) of
  ``points`` points, a ring of ``views`` cameras of ``image_hw`` pixels
  (normalized images drawn N(0, 1)), and ``gt_boxes`` boxes in the room
  with labels below the configuration's class count (copied from the
  port's smoke run, ``make_request`` / ``make_batch`` / ``gt_boxes``);
- ``occ_room``: a 6.2 m room inside mv_occ's point range (floor, four
  walls up to 1.7 m, a table top), cameras 7 m above, and with
  ``gt_voxels`` the occupied prior-grid cells (labelled by surface, or
  with p 0.3 a random class) padded to that many rows, and a visibility
  mask (``make_occ_request``).

Every scene of a pool has its own stream (``spec.sub_seed(seed, 'scene',
i)``), so the same seed gives the same scenes in any order, and each
scene of one kind has the same sizes. ``batch`` scenes make one batch;
``pool`` batches are made and cycled.
"""

import math

import torch

from ..harness.spec import sub_seed


def _gen(device, seed):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def _ring_proj(v, hw, device):
    k = torch.tensor([[500.0, 0, hw / 2, 0], [0, 500.0, hw / 2, 0],
                      [0, 0, 1, 0], [0, 0, 0, 1]], device=device)
    ext = torch.eye(4, device=device).repeat(v, 1, 1)
    ext[:, 0, 3] = -4.0 + 0.1 * torch.arange(v, device=device)
    ext[:, 1, 3] = -4.0
    ext[:, 2, 3] = 8.0
    return k @ ext


def det_room(t: dict, conf: dict, g, device) -> dict:
    p, v, hw = t['points'], t['views'], t['image_hw']
    u = torch.rand((p, 2), generator=g, device=device) * 8
    which = torch.randint(0, 3, (p, 1), generator=g, device=device)
    zero = torch.zeros_like(u[:, :1])
    floor = torch.cat([u, zero], 1)
    wall_x = torch.cat([u[:, :1], zero, u[:, 1:] * 3 / 8], 1)
    wall_y = torch.cat([zero, u[:, :1], u[:, 1:] * 3 / 8], 1)
    pts = torch.where(which == 0, floor, torch.where(which == 1, wall_x,
                                                     wall_y))
    pts = pts + torch.randn((p, 3), generator=g, device=device) * 0.01
    scene = dict(points=pts, points_mask=torch.ones(p, dtype=torch.bool,
                                                    device=device),
                 imgs=torch.randn((v, hw, hw, 3), generator=g, device=device),
                 proj=_ring_proj(v, hw, device),
                 aug_inv=torch.eye(4, device=device))
    n = t.get('gt_boxes', 0)
    if n:
        lo = torch.tensor([0.5, 0.5, 0.2] + [0.2] * 3 + [-0.5] * 3,
                          device=device)
        hi = torch.tensor([7.5, 7.5, 2.0] + [1.5] * 3 + [0.5] * 3,
                          device=device)
        scene.update(
            gt_boxes=lo + (hi - lo) * torch.rand((n, 9), generator=g,
                                                 device=device),
            gt_labels=torch.randint(0, conf['model']['num_classes'], (n, ),
                                    generator=g, device=device,
                                    dtype=torch.int32),
            gt_mask=torch.ones(n, dtype=torch.bool, device=device))
    return scene


def occ_room(t: dict, conf: dict, g, device) -> dict:
    p, v, hw = t['points'], t['views'], t['image_hw']
    m = conf['model']
    u = torch.rand((p, 2), generator=g, device=device)
    a, h = -3.1 + 6.2 * u[:, 0], -0.7 + 2.4 * u[:, 1]
    which = torch.randint(0, 6, (p, ), generator=g, device=device)
    c = torch.full_like(a, 3.1)
    faces = torch.stack([
        torch.stack([a, -3.1 + 6.2 * u[:, 1], torch.full_like(a, -0.7)], -1),
        torch.stack([-c, a, h], -1), torch.stack([c, a, h], -1),
        torch.stack([a, -c, h], -1), torch.stack([a, c, h], -1),
        torch.stack([-1 + 2 * u[:, 0], -0.5 + u[:, 1],
                     torch.full_like(a, 0.05)], -1)])
    pts = faces[which, torch.arange(p, device=device)]
    pts = pts + torch.randn((p, 3), generator=g, device=device) * 0.01
    k = torch.tensor([[0.8 * hw, 0, hw / 2, 0], [0, 0.8 * hw, hw / 2, 0],
                      [0, 0, 1, 0], [0, 0, 0, 1]], device=device)
    ext = torch.eye(4, device=device).repeat(v, 1, 1)
    i = torch.arange(v, device=device, dtype=torch.float32)
    ext[:, 0, 3] = 0.3 * i - 0.15 * (v - 1)
    ext[:, 1, 3] = 0.2 * i - 0.1 * (v - 1)
    ext[:, 2, 3] = 7.0
    scene = dict(points=pts, points_mask=torch.ones(p, dtype=torch.bool,
                                                    device=device),
                 imgs=torch.randn((v, hw, hw, 3), generator=g, device=device),
                 proj=k @ ext, aug_inv=torch.eye(4, device=device))
    n_gt = t.get('gt_voxels', 0)
    if n_gt:
        rng = m['point_cloud_range']
        cell = (rng[3] - rng[0]) / m['n_voxels'][0]
        origin = torch.tensor(rng[:3], device=device)
        cells = torch.floor((pts - origin) / cell).to(torch.int64)
        uniq, inv = torch.unique(cells, dim=0, return_inverse=True)
        first = torch.full((uniq.shape[0], ), p, dtype=torch.int64,
                           device=device).scatter_reduce_(
            0, inv, torch.arange(p, device=device), 'amin')
        rand = torch.rand(uniq.shape[0], generator=g, device=device)
        other = torch.randint(1, m['occ_classes'], (uniq.shape[0], ),
                              generator=g, device=device)
        labels = torch.where(rand < 0.3, other, which[first] + 1)
        n = min(uniq.shape[0], n_gt)
        gt = torch.zeros((n_gt, 4), device=device)
        gt[:n] = torch.cat([uniq, labels[:, None]], 1)[:n].float()
        gm = torch.zeros(n_gt, dtype=torch.bool, device=device)
        gm[:n] = True
        nv = tuple(m['n_voxels'])
        scene.update(gt_occ=gt, gt_occ_mask=gm,
                     visible_mask=torch.rand(nv, generator=g,
                                             device=device) > 0.15)
    return scene


SCENES = dict(det_room=det_room, occ_room=occ_room)


def scene(t: dict, conf: dict, seed: int, index: int, device) -> dict:
    """Scene ``index`` of the traffic ``t`` under ``seed``."""
    g = _gen(device, sub_seed(seed, 'scene', index))
    return SCENES[t['scene']](t, conf, g, device)


def batch(t: dict, conf: dict, seed: int, index: int, device) -> dict:
    """Batch ``index``: scenes ``index * batch ... + batch - 1`` stacked."""
    b = t['batch']
    scenes = [scene(t, conf, seed, index * b + j, device) for j in range(b)]
    return {k: torch.stack([s[k] for s in scenes]) for k in scenes[0]}


def pool(t: dict, conf: dict, seed: int, device) -> list:
    return [batch(t, conf, seed, i, device) for i in range(t['pool'])]


def arrivals(t: dict, seconds: float) -> list:
    """Due times (s from the window's start) of the requests of an open
    loop at ``rate_per_s``, evenly spaced, that fall inside the window."""
    n = math.ceil(seconds * t['rate_per_s'])
    return [i / t['rate_per_s'] for i in range(n)]
