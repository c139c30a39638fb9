"""The PyTorch port's Blender-format dataset loader and PNG reader against
the JAX package's loader (which reads PNGs through imageio), on the CPU, on
tiny sets written here with PNGs whose rows use all five filter types.

Tolerances: images, masks, poses, K and the flip equal exactly (the same
bytes, divided by 255 in float64 and cast, on both sides); dataset_rays
within 1e-6 (f32 division and normalisation, a 3x3 product summed in
another order)."""

import json
import os
import struct
import zlib

import imageio.v2 as imageio
import numpy as np
import pytest
from scipy.spatial.transform import Rotation

from avatarcraft_tpu.cameras.rays import dataset_rays as jax_dataset_rays
from avatarcraft_tpu.data import SMPLMultiviewDataset as JaxDataset
from avatarcraft_tpu_torch.cameras import dataset_rays
from avatarcraft_tpu_torch.data import SMPLMultiviewDataset
from avatarcraft_tpu_torch.utils.png import read_png, write_png


def _chunk(tag: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def write_filtered_png(path, img: np.ndarray, depth: int = 8, color: int | None = None, interlace: int = 0) -> None:
    """An 8-bit RGB/RGBA PNG whose row y uses filter type y % 5 (None,
    Sub, Up, Average, Paeth; PNG specification 9.2), split over two IDAT
    chunks. ``depth``, ``color`` and ``interlace`` only relabel the header,
    to make PNGs the reader must refuse."""
    h, w, ch = img.shape
    bpp = ch
    rows = img.reshape(h, w * ch).astype(np.int64)
    out = []
    prev = np.zeros(w * ch, np.int64)
    for y in range(h):
        x = rows[y]
        a = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int64), prev[:-bpp]])
        pred = [np.zeros_like(x), a, prev, (a + prev) // 2, _paeth(a, prev, c)][y % 5]
        out.append(bytes([y % 5]) + ((x - pred) % 256).astype(np.uint8).tobytes())
        prev = x
    data = zlib.compress(b"".join(out), 9)
    color = {3: 2, 4: 6}[ch] if color is None else color
    with open(path, "wb") as fp:
        fp.write(b"\x89PNG\r\n\x1a\n")
        fp.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace)))
        fp.write(_chunk(b"tEXt", b"Comment\x00ancillary chunks are skipped"))
        fp.write(_chunk(b"IDAT", data[: len(data) // 2]))
        fp.write(_chunk(b"IDAT", data[len(data) // 2 :]))
        fp.write(_chunk(b"IEND", b""))


def write_blender_set(root, images, poses, camera_angle_x: float = 0.7) -> None:
    """transforms_train.json + train/r_{i}.png, the layout both loaders read."""
    os.makedirs(os.path.join(root, "train"), exist_ok=True)
    frames = []
    for i, (img, pose) in enumerate(zip(images, poses)):
        write_filtered_png(os.path.join(root, "train", f"r_{i}.png"), img)
        frames.append({"file_path": f"./train/r_{i}", "transform_matrix": np.asarray(pose).tolist()})
    with open(os.path.join(root, "transforms_train.json"), "w") as fp:
        json.dump({"camera_angle_x": camera_angle_x, "frames": frames}, fp)


def random_poses(rng, n):
    poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    poses[:, :3, :3] = Rotation.random(n, random_state=int(rng.integers(1 << 30))).as_matrix()
    poses[:, :3, 3] = rng.normal(scale=2.0, size=(n, 3))
    return poses


@pytest.mark.parametrize("channels", [3, 4])
def test_read_png_every_filter(tmp_path, rng, channels):
    img = rng.integers(0, 256, size=(11, 7, channels), dtype=np.uint8)
    img[3:6] = img[2]  # runs of equal rows and pixels: the Up/Paeth ties
    path = str(tmp_path / "f.png")
    write_filtered_png(path, img)
    got = read_png(path)
    assert got.dtype == np.uint8 and got.shape == img.shape
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(got, imageio.imread(path))


def test_read_png_reads_the_writer(tmp_path, rng):
    img = rng.integers(0, 256, size=(5, 9, 3), dtype=np.uint8)
    write_png(str(tmp_path / "w.png"), img)
    np.testing.assert_array_equal(read_png(str(tmp_path / "w.png")), img)


@pytest.mark.parametrize("depth,color,interlace,name", [
    (16, 2, 0, "16-bit RGB"), (8, 0, 0, "8-bit gray"), (8, 3, 0, "8-bit palette"),
    (8, 4, 0, "8-bit gray\\+alpha"), (8, 2, 1, "8-bit RGB PNG \\(interlaced\\)"),
])
def test_read_png_refuses_other_formats(tmp_path, depth, color, interlace, name):
    path = str(tmp_path / "x.png")
    write_filtered_png(path, np.zeros((2, 2, 3), np.uint8), depth=depth, color=color, interlace=interlace)
    with pytest.raises(ValueError, match=name):
        read_png(path)
    with open(path, "wb") as fp:
        fp.write(b"GIF89a")
    with pytest.raises(ValueError, match="not a PNG"):
        read_png(path)


@pytest.fixture
def blender_set(tmp_path, rng):
    """3 RGBA views of 10x14 with transparent (all-zero) pixels."""
    images = rng.integers(0, 256, size=(3, 10, 14, 4), dtype=np.uint8)
    images[:, :4, :5] = 0
    poses = random_poses(rng, 3)
    write_blender_set(str(tmp_path), images, poses)
    return str(tmp_path), images, poses


def test_loaders_agree(blender_set):
    root, images, poses = blender_set
    port, ref = SMPLMultiviewDataset(root), JaxDataset(root)
    for name in ("images", "masks", "poses", "K"):
        a, b = getattr(port, name), getattr(ref, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert (port.n_images, port.H, port.W, port.focal) == (ref.n_images, ref.H, ref.W, ref.focal) == (3, 10, 14, ref.focal)
    # the reference's horizontal flip, and masks from the flipped images
    np.testing.assert_array_equal(port.images[1, :, 0], images[1, :, -1] / np.float32(255.0))
    assert port.masks[0, :4, -5:].sum() == 0 and port.masks[0, :4, :-5].all()


@pytest.mark.parametrize("level", [1, 2])
def test_dataset_rays_agree(blender_set, level):
    root, _, poses = blender_set
    port, ref = SMPLMultiviewDataset(root), JaxDataset(root)
    for i in range(3):
        got = port.gen_rays_pose(poses[i], level, device="cpu")
        want = ref.gen_rays_pose(poses[i], level)
        for g, w in zip(got, want):
            assert g.shape == w.shape == (10 // level * (14 // level), 3)
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
    got = dataset_rays(poses[1], port.K, 9, 13, 3, device="cpu")
    want = jax_dataset_rays(poses[1], port.K, 9, 13, 3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
