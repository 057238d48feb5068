"""``det_room``: an 8 m room (floor and two walls, 1 cm noise) of
``points`` points, a ring of ``views`` cameras of ``image_hw`` pixels
(normalized images drawn N(0, 1)), and ``gt_boxes`` boxes in the room with
labels below the configuration's class count (copied from the port's smoke
run, ``make_request`` / ``make_batch`` / ``gt_boxes``)."""

import torch


def _ring_proj(v, hw, device):
    k = torch.tensor([[500.0, 0, hw / 2, 0], [0, 500.0, hw / 2, 0],
                      [0, 0, 1, 0], [0, 0, 0, 1]], device=device)
    ext = torch.eye(4, device=device).repeat(v, 1, 1)
    ext[:, 0, 3] = -4.0 + 0.1 * torch.arange(v, device=device)
    ext[:, 1, 3] = -4.0
    ext[:, 2, 3] = 8.0
    return k @ ext


def make(t: dict, conf: dict, g, device) -> dict:
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
