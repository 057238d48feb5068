"""Raw-data converters a user runs before training (port of
``embodiedscan_tpu/converters.py``; stdlib, numpy and PIL on the host).

- ``extract_sens``: a ScanNet ``.sens`` stream (header, then per frame a
  pose, a JPEG color image and a zlib uint16 depth map) into rgb/, depth/
  and pose/ trees; ``write_sens`` writes a minimal v4 stream.
- ``extract_3rscan_zip``: a 3RScan sequence zip's color, depth, pose and
  info files.
- ``distribute_occupancy_anns``: a bundled occupancy archive (zip or
  directory) into per-scene npy files.
"""

import os
import struct
import zipfile
import zlib
from typing import Optional

import numpy as np

COLOR_COMPRESSION = {-1: 'unknown', 0: 'raw', 1: 'png', 2: 'jpeg'}
DEPTH_COMPRESSION = {0: 'raw_ushort', 1: 'zlib_ushort', 2: 'occi_ushort'}


def extract_sens(sens_path: str, out_dir: str, frame_skip: int = 1,
                 limit: Optional[int] = None) -> int:
    """Extract a ScanNet .sens stream into rgb/, depth/, pose/ trees.

    Returns the number of frames written.
    """
    os.makedirs(os.path.join(out_dir, 'rgb'), exist_ok=True)
    os.makedirs(os.path.join(out_dir, 'depth'), exist_ok=True)
    os.makedirs(os.path.join(out_dir, 'pose'), exist_ok=True)
    written = 0
    with open(sens_path, 'rb') as f:
        version = struct.unpack('I', f.read(4))[0]
        assert version == 4, f'unsupported .sens version {version}'
        strlen = struct.unpack('Q', f.read(8))[0]
        f.read(strlen)  # sensor name
        intrinsic_color = np.frombuffer(f.read(16 * 4), np.float32).reshape(
            4, 4)
        f.read(16 * 4)  # extrinsic_color
        intrinsic_depth = np.frombuffer(f.read(16 * 4), np.float32).reshape(
            4, 4)
        f.read(16 * 4)  # extrinsic_depth
        color_comp = struct.unpack('i', f.read(4))[0]
        depth_comp = struct.unpack('i', f.read(4))[0]
        cw, ch, dw, dh = struct.unpack('IIII', f.read(16))
        depth_shift = struct.unpack('f', f.read(4))[0]
        num_frames = struct.unpack('Q', f.read(8))[0]
        np.savetxt(os.path.join(out_dir, 'intrinsic_color.txt'),
                   intrinsic_color)
        np.savetxt(os.path.join(out_dir, 'intrinsic_depth.txt'),
                   intrinsic_depth)
        with open(os.path.join(out_dir, 'meta.txt'), 'w') as m:
            m.write(f'depth_shift {depth_shift}\n'
                    f'color {cw}x{ch} {COLOR_COMPRESSION.get(color_comp)}\n'
                    f'depth {dw}x{dh} {DEPTH_COMPRESSION.get(depth_comp)}\n')
        for i in range(num_frames):
            pose = np.frombuffer(f.read(16 * 4), np.float32).reshape(4, 4)
            f.read(8)  # timestamp color
            f.read(8)  # timestamp depth
            color_size = struct.unpack('Q', f.read(8))[0]
            depth_size = struct.unpack('Q', f.read(8))[0]
            color_bytes = f.read(color_size)
            depth_bytes = f.read(depth_size)
            if i % frame_skip != 0:
                continue
            name = f'{i:06d}'
            np.savetxt(os.path.join(out_dir, 'pose', name + '.txt'), pose)
            if COLOR_COMPRESSION.get(color_comp) == 'jpeg':
                with open(os.path.join(out_dir, 'rgb', name + '.jpg'),
                          'wb') as c:
                    c.write(color_bytes)
            else:
                from PIL import Image
                arr = np.frombuffer(color_bytes, np.uint8)
                Image.fromarray(arr.reshape(ch, cw, -1)).save(
                    os.path.join(out_dir, 'rgb', name + '.jpg'))
            if DEPTH_COMPRESSION.get(depth_comp) == 'zlib_ushort':
                depth = np.frombuffer(zlib.decompress(depth_bytes),
                                      np.uint16).reshape(dh, dw)
            else:
                depth = np.frombuffer(depth_bytes, np.uint16).reshape(dh, dw)
            from PIL import Image
            Image.fromarray(depth).save(
                os.path.join(out_dir, 'depth', name + '.png'))
            written += 1
            if limit is not None and written >= limit:
                break
    return written


def write_sens(path: str, frames: list, intrinsic: np.ndarray,
               depth_shift: float = 1000.0):
    """Write a minimal v4 .sens file (testing/round-trip utility).

    frames: list of dicts with 'pose' (4,4), 'color_jpeg' (bytes),
    'depth' (H, W) uint16.
    """
    dh, dw = frames[0]['depth'].shape
    with open(path, 'wb') as f:
        f.write(struct.pack('I', 4))
        name = b'synthetic'
        f.write(struct.pack('Q', len(name)))
        f.write(name)
        k = np.eye(4, dtype=np.float32)
        k[:intrinsic.shape[0], :intrinsic.shape[1]] = intrinsic
        f.write(k.astype(np.float32).tobytes())  # intrinsic color
        f.write(np.eye(4, dtype=np.float32).tobytes())
        f.write(k.astype(np.float32).tobytes())  # intrinsic depth
        f.write(np.eye(4, dtype=np.float32).tobytes())
        f.write(struct.pack('i', 2))  # jpeg
        f.write(struct.pack('i', 1))  # zlib_ushort
        f.write(struct.pack('IIII', dw, dh, dw, dh))
        f.write(struct.pack('f', depth_shift))
        f.write(struct.pack('Q', len(frames)))
        for fr in frames:
            f.write(np.asarray(fr['pose'], np.float32).tobytes())
            f.write(struct.pack('Q', 0))
            f.write(struct.pack('Q', 0))
            depth_bytes = zlib.compress(
                np.asarray(fr['depth'], np.uint16).tobytes())
            f.write(struct.pack('Q', len(fr['color_jpeg'])))
            f.write(struct.pack('Q', len(depth_bytes)))
            f.write(fr['color_jpeg'])
            f.write(depth_bytes)


def extract_3rscan_zip(zip_path: str, out_dir: str) -> int:
    """Unpack a 3RScan sequence zip (color jpg / depth pgm / pose txt)."""
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    with zipfile.ZipFile(zip_path) as z:
        for name in z.namelist():
            if name.endswith(('.color.jpg', '.depth.pgm', '.pose.txt',
                              '_info.txt')):
                z.extract(name, out_dir)
                n += 1
    return n


def distribute_occupancy_anns(bundle_path: str, out_root: str) -> int:
    """Split a bundled occupancy annotation archive into per-scene npy files.

    The bundle is a zip (or directory) of ``<scan_id>/occupancy.npy``
    entries; each is copied to ``<out_root>/<scan_id>/occupancy.npy``
    (extract_occupancy_ann.py behavior).
    """
    n = 0
    if os.path.isdir(bundle_path):
        import shutil
        for root, _, files in os.walk(bundle_path):
            for fn in files:
                if fn.endswith('.npy'):
                    rel = os.path.relpath(os.path.join(root, fn), bundle_path)
                    dst = os.path.join(out_root, rel)
                    os.makedirs(os.path.dirname(dst), exist_ok=True)
                    shutil.copyfile(os.path.join(root, fn), dst)
                    n += 1
        return n
    with zipfile.ZipFile(bundle_path) as z:
        for name in z.namelist():
            if name.endswith('.npy'):
                z.extract(name, out_root)
                n += 1
    return n
