"""``occ_room``: a 6.2 m room inside mv_occ's point range (floor, four
walls up to 1.7 m, a table top), cameras 7 m above, and with ``gt_voxels``
the occupied prior-grid cells (labelled by surface, or with p 0.3 a random
class) padded to that many rows, and a visibility mask
(``make_occ_request``)."""

import torch


def make(t: dict, conf: dict, g, device) -> dict:
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
