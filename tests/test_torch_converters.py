"""The raw-data converters against the reference package on the same
inputs: the ``.sens`` writer's stream and every file the extractors
write are byte-identical, and the counts they return are equal."""

import io
import os
import zipfile

import numpy as np
import pytest

from embodiedscan_tpu import converters as jC
from embodiedscan_torch import converters as tC

SIDES = (('jax', jC), ('torch', tC))


def _tree(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for base, _, files in os.walk(root):
        for name in files:
            path = os.path.join(base, name)
            with open(path, 'rb') as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _frames(n=5, hw=(24, 32)):
    from PIL import Image
    rng = np.random.RandomState(0)
    frames = []
    for i in range(n):
        buf = io.BytesIO()
        Image.fromarray(rng.randint(0, 255, hw + (3, )).astype(
            np.uint8)).save(buf, format='JPEG')
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = np.linalg.qr(rng.randn(3, 3))[0]
        pose[:3, 3] = rng.uniform(-2, 2, 3)
        frames.append(dict(pose=pose, color_jpeg=buf.getvalue(),
                           depth=rng.randint(0, 6000, hw).astype(np.uint16)))
    return frames


@pytest.mark.parametrize('frame_skip,limit', [(1, None), (2, None), (1, 3)])
def test_sens_round_trip(tmp_path, frame_skip, limit):
    frames = _frames()
    k = np.array([[30.0, 0, 16], [0, 30, 12], [0, 0, 1]], np.float32)
    counts = []
    for side, C in SIDES:
        C.write_sens(str(tmp_path / f'{side}.sens'), frames, k,
                     depth_shift=4000.0)
        counts.append(C.extract_sens(str(tmp_path / f'{side}.sens'),
                                     str(tmp_path / side), frame_skip, limit))
    assert (tmp_path / 'jax.sens').read_bytes() == \
        (tmp_path / 'torch.sens').read_bytes()
    assert counts[0] == counts[1] == len(frames[::frame_skip][:limit])
    want, got = _tree(tmp_path / 'jax'), _tree(tmp_path / 'torch')
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name
    # the round trip: depth and poses back as written
    from PIL import Image
    depth = np.asarray(Image.open(tmp_path / 'torch' / 'depth' /
                                  '000000.png'))
    np.testing.assert_array_equal(depth, frames[0]['depth'])


def _bundle_entries():
    rng = np.random.RandomState(1)
    out = {}
    for scan in ('scannet/scene0000_00', 'scannet/scene0001_00',
                 '3rscan/abc'):
        arr = io.BytesIO()
        np.save(arr, rng.randint(0, 80, (7, 4)))
        out[f'{scan}/occupancy.npy'] = arr.getvalue()
    out['README.txt'] = b'not an annotation'
    return out


@pytest.mark.parametrize('kind', ['zip', 'dir'])
def test_distribute_occupancy_anns(tmp_path, kind):
    entries = _bundle_entries()
    bundle = tmp_path / 'bundle'
    if kind == 'zip':
        bundle = tmp_path / 'occ.zip'
        with zipfile.ZipFile(bundle, 'w') as z:
            for name, data in entries.items():
                z.writestr(name, data)
    else:
        for name, data in entries.items():
            os.makedirs(os.path.dirname(bundle / name), exist_ok=True)
            (bundle / name).write_bytes(data)
    counts = [C.distribute_occupancy_anns(str(bundle), str(tmp_path / side))
              for side, C in SIDES]
    assert counts == [3, 3]
    assert _tree(tmp_path / 'torch') == _tree(tmp_path / 'jax')


def test_extract_3rscan_zip(tmp_path):
    zp = tmp_path / 'seq.zip'
    with zipfile.ZipFile(zp, 'w') as z:
        for i in range(3):
            z.writestr(f'sequence/frame-{i:06d}.color.jpg', b'jpg%d' % i)
            z.writestr(f'sequence/frame-{i:06d}.depth.pgm', b'pgm%d' % i)
            z.writestr(f'sequence/frame-{i:06d}.pose.txt', b'1 0 0 %d' % i)
        z.writestr('sequence/_info.txt', b'm_colorWidth = 960')
        z.writestr('sequence/ignore.bin', b'zz')
    counts = [C.extract_3rscan_zip(str(zp), str(tmp_path / side))
              for side, C in SIDES]
    assert counts == [10, 10]
    assert _tree(tmp_path / 'torch') == _tree(tmp_path / 'jax')
