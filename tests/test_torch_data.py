"""The port's data pipeline against the JAX package's, on the CPU: the
synthetic-folder writer, `ImageDataset`, the `Loader`'s batches and order,
and the native preprocessing library.

Both packages decode the same files with the same libraries (PIL, the
native C++ library built from the one `native/preprocess.cpp`), so every
comparison is exact: arrays equal bit for bit, no tolerance. The native
library, where no compiler is present, is skipped on both sides alike.
"""
import os

import numpy as np
import pytest

from animals3d_tpu import native as jnative
from animals3d_tpu.data import image_dataset as jds
from animals3d_tpu.data import loaders as jloaders
from animals3d_tpu.data import synth as jsynth
from animals3d_tpu.data import util as jutil
from animals3d_tpu_torch import native as tnative
from animals3d_tpu_torch.data import image_dataset as tds
from animals3d_tpu_torch.data import loaders as tloaders
from animals3d_tpu_torch.data import synth as tsynth
from animals3d_tpu_torch.data import util as tutil

N, SIZE, DIM = 5, 64, 4


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """(JAX-written folder, port-written folder), one seed."""
    d = tmp_path_factory.mktemp("synth")
    jsynth.write_synth_dataset(str(d / "jax"), n=N, size=SIZE, dino_dim=DIM,
                               seed=3)
    tsynth.write_synth_dataset(str(d / "port"), n=N, size=SIZE, dino_dim=DIM,
                               seed=3)
    return str(d / "jax"), str(d / "port")


def _decode(path):
    from PIL import Image
    if path.endswith(".txt"):
        return np.loadtxt(path, dtype=str)
    return np.asarray(Image.open(path))


def test_synth_writers_write_the_same_folder(folders):
    """Same file names; every image decodes to the same array and every
    box file reads the same."""
    jdir, tdir = folders
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir))
    assert len(names) == 4 * N + 1          # rgb, mask, box, feat; background
    for name in names:
        np.testing.assert_array_equal(_decode(os.path.join(tdir, name)),
                                      _decode(os.path.join(jdir, name)),
                                      err_msg=name)


@pytest.mark.parametrize("xflip", [False, True])
def test_image_dataset_samples_equal_jax(folders, xflip):
    """Every field of every sample of a folder the JAX package wrote, with
    DINO features and the background crop loaded, bit for bit; with
    `random_xflip` both draw the flip from numpy's global generator."""
    jdir, _ = folders
    kw = dict(in_image_size=SIZE, out_image_size=SIZE, load_background=True,
              random_xflip=xflip, load_dino_feature=True,
              dino_feature_dim=DIM)
    jd, td = jds.ImageDataset(jdir, **kw), tds.ImageDataset(jdir, **kw)
    assert len(td) == len(jd) == N
    for i in range(N):
        np.random.seed(i)
        want = jd[i]
        np.random.seed(i)
        got = td[i]
        assert set(got) == set(want)
        for k, w in want.items():
            if w is None:
                assert got[k] is None, k
                continue
            assert got[k].dtype == w.dtype, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_loader_batches_equal_jax_over_two_shuffled_epochs(folders):
    """The train stream of `get_data_loaders` (shuffled, infinite, batch 2
    over 5 samples, so batches straddle the epochs): the first five
    batches, two epochs, equal JAX's in order and content."""
    jdir, _ = folders
    cfg = dict(batch_size=2, num_workers=2, in_image_size=SIZE,
               out_image_size=SIZE, train_data_dir=jdir,
               random_shuffle_samples_train=True, load_dino_feature=True,
               dino_feature_dim=DIM)
    jtrain, _, _ = jloaders.get_data_loaders(
        jloaders.DataLoaderConfig(**cfg))
    ttrain, _, _ = tloaders.get_data_loaders(
        tloaders.DataLoaderConfig(**cfg))
    assert len(ttrain) == len(jtrain) == 2
    jit, tit = iter(jtrain), iter(ttrain)
    seen = []
    for _ in range(5):
        want, got = next(jit), next(tit)
        assert set(got) == set(want)
        for k, w in want.items():
            if w is None:
                assert got[k] is None, k
            else:
                np.testing.assert_array_equal(got[k], w, err_msg=k)
        seen += got["seq_idx"].tolist()
    # two epochs: each a permutation, and the two differ
    assert sorted(seen[:N]) == sorted(seen[N:]) == list(range(N))
    assert seen[:N] != seen[N:]


def test_finite_loader_keeps_the_last_partial_batch(folders):
    """A test loader: no shuffle, one pass, the partial batch kept."""
    jdir, _ = folders
    cfg = dict(batch_size=2, num_workers=1, in_image_size=SIZE,
               out_image_size=SIZE, test_data_dir=jdir)
    _, _, jtest = jloaders.get_data_loaders(jloaders.DataLoaderConfig(**cfg))
    _, _, ttest = tloaders.get_data_loaders(tloaders.DataLoaderConfig(**cfg))
    jb, tb = list(jtest), list(ttest)
    assert [b["images"].shape[0] for b in tb] == [2, 2, 1]
    for want, got in zip(jb, tb):
        np.testing.assert_array_equal(got["images"], want["images"])
        np.testing.assert_array_equal(got["seq_idx"], want["seq_idx"])


def _native_or_skip():
    if jnative.get_lib() is None or tnative.get_lib() is None:
        pytest.skip("no C++ toolchain")


def test_native_distance_transform_equals_jax():
    _native_or_skip()
    rng = np.random.default_rng(0)
    mask = (rng.uniform(0, 1, (1, 48, 64)) > 0.7).astype(np.float32)
    mask[0, 10:30, 20:50] = 1.0
    got = tnative.mask_distance_transform(mask)
    np.testing.assert_array_equal(got, jnative.mask_distance_transform(mask))
    np.testing.assert_array_equal(tutil.compute_distance_transform(mask),
                                  jutil.compute_distance_transform(mask))
    assert tutil.distance_transform_backend() == "native"


def test_native_feature_decode_and_resize_equal_jax():
    _native_or_skip()
    rng = np.random.default_rng(1)
    img = rng.integers(0, 255, (16, 6 * 16, 3)).astype(np.uint8)
    for ch in (4, 16):
        np.testing.assert_array_equal(tnative.decode_packed_feat(img, ch),
                                      jnative.decode_packed_feat(img, ch))
        np.testing.assert_array_equal(tutil.decode_feat_from_img(img, ch),
                                      jutil.decode_feat_from_img(img, ch))
    arr = rng.uniform(0, 1, (3, 20, 30)).astype(np.float32)
    np.testing.assert_array_equal(tnative.resize_bilinear(arr, 7, 11),
                                  jnative.resize_bilinear(arr, 7, 11))


def test_python_distance_transform_paths_agree(monkeypatch):
    """Without the native library `compute_distance_transform` takes cv2,
    and without cv2 scipy (the JAX order), each within 1e-3 px of the
    native transform."""
    import sys
    _native_or_skip()
    rng = np.random.default_rng(2)
    mask = (rng.uniform(0, 1, (1, 40, 40)) > 0.6).astype(np.float32)
    want = tnative.mask_distance_transform(mask)
    monkeypatch.setattr(tnative, "get_lib", lambda: None)
    assert tutil.distance_transform_backend() == "cv2"
    np.testing.assert_allclose(tutil.compute_distance_transform(mask), want,
                               atol=1e-3)
    monkeypatch.setitem(sys.modules, "cv2", None)      # import cv2 fails
    assert tutil.distance_transform_backend() == "scipy"
    np.testing.assert_allclose(tutil.compute_distance_transform(mask), want,
                               atol=1e-3)


def test_box_valid_mask_and_flip_equal_jax(tmp_path):
    """Box parsing (a file and the default box), the crop validity mask and
    the box flip."""
    path = str(tmp_path / "000000_box.txt")
    np.savetxt(path, np.array([[7, 40, 30, 300, 200, 320, 240, 3.0]]),
               fmt="%s")
    for p in (path, str(tmp_path / "missing_box.txt")):
        box = tutil.box_loader(p)
        np.testing.assert_array_equal(box, jutil.box_loader(p))
        np.testing.assert_array_equal(tutil.get_valid_mask(box, 32),
                                      jutil.get_valid_mask(box, 32))
        np.testing.assert_array_equal(tutil.horizontal_flip_box(box[None]),
                                      jutil.horizontal_flip_box(box[None]))


def test_an_abandoned_infinite_loader_stops_its_producer(folders):
    """A train stream left after a few batches (the loop's end) stops its
    producer thread once the iterator is closed; a decode error reaches
    the consumer."""
    import threading
    import time
    jdir, _ = folders
    ds = tds.ImageDataset(jdir, in_image_size=SIZE, out_image_size=SIZE)
    before = threading.active_count()
    it = iter(tloaders.Loader(ds, 2, shuffle=True, num_workers=2,
                              infinite=True))
    for _ in range(3):
        next(it)
    it.close()
    deadline = time.time() + 10
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before

    class Broken:
        def __len__(self):
            return 3

        def __getitem__(self, i):
            raise OSError(f"cannot decode sample {i}")
    with pytest.raises(OSError, match="cannot decode"):
        next(iter(tloaders.Loader(Broken(), 2, num_workers=1)))
