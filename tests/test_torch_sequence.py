"""The port's sequence data, its PNG codec, its smoothness losses and its
Ponymation configs against the JAX package's, on the CPU.

  * `smooth_loss`: every smoothing type and both loss types on odd and
    even frame counts (`jnp.median` averages the two middle values of an
    even count), values and input gradients at rtol 1e-6;
  * `util.png_read` / `png_write`, the numpy and zlib PNG codec the port
    decodes its 16-bit flows with (the port does not require cv2): equal
    to cv2 here on the files cv2 writes, on rows of all five filter
    types, and on what it writes itself; it raises on the forms it does
    not decode;
  * the synthetic sequence writer, `NFrameSequenceDataset` (dense and
    random windows, front padding, background crops, DINO features, the
    x-flip and resized flows) and the `sequence` loader, bit for bit
    against the JAX package's on the same folders;
  * the port's `save_results` flow files, and each Ponymation YAML loaded
    to the same dict as its JAX twin.
"""
import os
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animals3d_tpu import config as jcfg
from animals3d_tpu.data import loaders as jloaders
from animals3d_tpu.data import sequence_dataset as jseq
from animals3d_tpu.data import synth as jsynth
from animals3d_tpu.data import util as jutil
from animals3d_tpu.utils.smooth_loss import smooth_loss as jsmooth
from animals3d_tpu_torch import config as tcfg
from animals3d_tpu_torch.data import loaders as tloaders
from animals3d_tpu_torch.data import sequence_dataset as tseq
from animals3d_tpu_torch.data import synth as tsynth
from animals3d_tpu_torch.data import util as tutil
from animals3d_tpu_torch.utils.smooth_loss import smooth_loss as tsmooth

SIZE, DIM = 32, 4
cv2 = pytest.importorskip("cv2")


# ---------------------------------------------------------------------------
# smoothness losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("frames", [3, 4])
@pytest.mark.parametrize("loss_type", ["l2", "l1"])
@pytest.mark.parametrize("smooth_type",
                         ["dislocation", "mid_frame", "avg", "median"])
def test_smooth_loss_matches_jax(smooth_type, loss_type, frames):
    """Value and gradient with respect to the input, rtol 1e-6 (atol
    1e-8); the median is detached on both sides."""
    x = np.random.default_rng(frames).normal(
        size=(2, frames, 5, 3)).astype(np.float32)
    want, jg = jax.value_and_grad(
        lambda a: jsmooth(a, smooth_type, loss_type))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    got = tsmooth(tx, smooth_type, loss_type)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-8)
    assert tsmooth(tx, None) == jsmooth(x, None) == 0.0


# ---------------------------------------------------------------------------
# the PNG codec
# ---------------------------------------------------------------------------

def _cv2_rgb(path):
    """cv2's decode in the file's channel order (it returns BGR[A])."""
    a = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if a.ndim == 2:
        return a[..., None]
    return np.concatenate([a[..., 2::-1], a[..., 3:]], -1)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_read_equals_cv2(tmp_path, dtype, channels):
    """A file cv2 writes (its own filter choice; smooth rows and noise),
    decoded by `png_read`, equals cv2's decode; `png_write`'s file
    decodes to the array in cv2 and in `png_read`."""
    r = np.random.default_rng(channels)
    top = np.iinfo(dtype).max
    a = (r.uniform(0, 1, (29, 41, channels)) * top).astype(dtype)
    a[:9] = (np.linspace(0, top, 41)[None, :, None]).astype(dtype)
    path = str(tmp_path / "cv2.png")
    cv2.imwrite(path, a[..., 0] if channels == 1 else
                np.concatenate([a[..., 2::-1], a[..., 3:]], -1))
    np.testing.assert_array_equal(tutil.png_read(path), _cv2_rgb(path))
    np.testing.assert_array_equal(tutil.png_read(path), a)
    path = str(tmp_path / "port.png")
    tutil.png_write(path, a)
    np.testing.assert_array_equal(_cv2_rgb(path), a)
    np.testing.assert_array_equal(tutil.png_read(path), a)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _png_with_filters(path, img, filters, interlace=0):
    """Write (H, W, 3) uint16 `img` as a PNG whose row i uses filter
    `filters[i % len(filters)]` (the encoder's side of the five PNG
    filters, written out here); `interlace` is only the header's flag."""
    h, w, _ = img.shape
    x = img.astype(">u2").view(np.uint8).reshape(h, -1).astype(np.int32)
    bpp = 6
    prev = np.zeros_like(x[0])
    rows = []
    for i in range(h):
        cur = x[i]
        a = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        c = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        f = filters[i % len(filters)]
        pred = [0, a, prev, (a + prev) >> 1, _paeth(a, prev, c)][f]
        rows.append(np.concatenate([[f], (cur - pred) & 0xFF]))
        prev = cur
    raw = np.stack(rows).astype(np.uint8).tobytes()

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)
    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n"
                 + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16, 2, 0, 0,
                                              interlace))
                 + chunk(b"IDAT", zlib.compress(raw))
                 + chunk(b"IEND", b""))


def test_png_read_undoes_all_five_filters(tmp_path):
    """Rows of filter types 0 to 4 in turn (and runs of one type), each
    undone to the image; cv2 decodes the same file to the same array."""
    img = (np.random.default_rng(5).uniform(0, 1, (23, 17, 3))
           * 65535).astype(np.uint16)
    for filters in ([0, 1, 2, 3, 4], [4], [3], [2, 3]):
        path = str(tmp_path / f"f{''.join(map(str, filters))}.png")
        _png_with_filters(path, img, filters)
        np.testing.assert_array_equal(tutil.png_read(path), img)
        np.testing.assert_array_equal(_cv2_rgb(path), img)


def test_png_read_raises_on_forms_it_does_not_decode(tmp_path):
    """A palette image and an interlaced one raise ValueError, as does a
    file that is not a PNG; a missing flow file raises FileNotFoundError
    (cv2's `None` in the JAX loader)."""
    from PIL import Image
    pal = str(tmp_path / "pal.png")
    Image.fromarray(np.arange(64, dtype=np.uint8).reshape(8, 8)) \
        .convert("P").save(pal)
    inter = str(tmp_path / "inter.png")
    _png_with_filters(inter, np.zeros((8, 8, 3), np.uint16), [0],
                      interlace=1)
    bogus = str(tmp_path / "bogus.png")
    with open(bogus, "wb") as f:
        f.write(b"not a png")
    for path in (pal, inter, bogus):
        with pytest.raises(ValueError):
            tutil.png_read(path)
    with pytest.raises(FileNotFoundError):
        tutil.flow_loader(str(tmp_path / "missing.png"))


# ---------------------------------------------------------------------------
# the sequence folders, the dataset and the loader
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def seq_folders(tmp_path_factory):
    """(JAX-written tree, port-written tree) of 2 sequences of 4 frames,
    one seed."""
    d = tmp_path_factory.mktemp("seq")
    for name, mod in (("jax", jsynth), ("port", tsynth)):
        mod.write_synth_dataset(str(d / name), size=SIZE, dino_dim=DIM,
                                sequences=2, frames=4, seed=3)
    return str(d / "jax"), str(d / "port")


def test_sequence_writers_write_the_same_tree(seq_folders):
    """Same folders and file names; images, masks and features decode to
    the same arrays, box files read the same, and every flow PNG decodes
    (by cv2) to the same 16-bit samples."""
    from PIL import Image
    jdir, tdir = seq_folders
    seqs = sorted(os.listdir(jdir))
    assert seqs == sorted(os.listdir(tdir)) == ["seq000", "seq001"]
    for s in seqs:
        names = sorted(os.listdir(os.path.join(jdir, s)))
        assert names == sorted(os.listdir(os.path.join(tdir, s)))
        assert len(names) == 5 * 4 + 1
        for n in names:
            jp, tp = os.path.join(jdir, s, n), os.path.join(tdir, s, n)
            if n.endswith(".txt"):
                want, got = np.loadtxt(jp, dtype=str), np.loadtxt(tp,
                                                                  dtype=str)
            elif n.endswith("flow.png"):
                want, got = _cv2_rgb(jp), _cv2_rgb(tp)
                assert got.dtype == np.uint16
            else:
                want = np.asarray(Image.open(jp))
                got = np.asarray(Image.open(tp))
            np.testing.assert_array_equal(got, want, err_msg=n)


def test_flow_loader_equals_cv2s(seq_folders):
    """The port's flow decode (numpy) equals the JAX package's (cv2,
    BGR flipped to RGB) on the JAX writer's files, bit for bit."""
    jdir, _ = seq_folders
    path = os.path.join(jdir, "seq001", "000002_flow.png")
    want = jutil.flow_loader(path)
    got = tutil.flow_loader(path)
    assert got.shape == (2, SIZE, SIZE) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert abs(float(got.mean())) < 0.1


def _same_sample(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        if w is None:
            assert got[k] is None, k
            continue
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)


CASES = {
    # 3-frame dense windows over 4-frame clips: the last two start frames
    # are short (the last moves back one frame, then pads in front)
    "dense": dict(num_frames=3),
    # 6-frame windows over 4-frame clips: every sample padded in front,
    # the padding's flows zero
    "padded": dict(num_frames=6),
    "random_xflip": dict(num_frames=3, random_sample=True,
                         random_xflip=True),
    "stride": dict(num_frames=2, dense_sample=False, out_image_size=16),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sequence_dataset_samples_equal_jax(seq_folders, case):
    """Every field of every sample, with flows, backgrounds and DINO
    features loaded, bit for bit on the JAX writer's tree; random windows
    and the flip draw from numpy's global generator on both sides; the
    "stride" case resizes the flows (PIL, bilinear, per channel)."""
    jdir, _ = seq_folders
    kw = dict(skip_beginning=0, skip_end=0, min_seq_len=2,
              in_image_size=SIZE, out_image_size=SIZE, load_flow=True,
              load_background=True, load_dino_feature=True,
              dino_feature_dim=DIM)
    kw.update(CASES[case])
    jd = jseq.NFrameSequenceDataset(jdir, **kw)
    td = tseq.NFrameSequenceDataset(jdir, **kw)
    assert len(td) == len(jd) > 0 and td.data_type == "sequence"
    for i in range(len(jd)):
        np.random.seed(i)
        want = jd[i]
        np.random.seed(i)
        got = td[i]
        _same_sample(got, want)
        F = kw["num_frames"]
        assert got["images"].shape[0] == F
        assert got["flows"].shape == (F - 1, 2, kw["out_image_size"],
                                      kw["out_image_size"])
    if case == "padded":
        assert not got["flows"][:2].any()


def test_sequence_loader_batches_equal_jax(seq_folders):
    """`get_data_loaders` with `data_type: sequence` (shuffled, infinite,
    batch 2 over 6 windows, so batches straddle the epochs; flows on):
    the first five batches equal JAX's in order and content."""
    jdir, _ = seq_folders
    cfg = dict(data_type="sequence", batch_size=2, num_workers=2,
               in_image_size=SIZE, out_image_size=SIZE, train_data_dir=jdir,
               test_data_dir=jdir, random_shuffle_samples_train=True,
               load_flow=True, load_dino_feature=True, dino_feature_dim=DIM,
               num_frames=3, skip_beginning=0, skip_end=1, min_seq_len=2)
    jtrain, _, jtest = jloaders.get_data_loaders(
        jloaders.DataLoaderConfig(**cfg))
    ttrain, _, ttest = tloaders.get_data_loaders(
        tloaders.DataLoaderConfig(**cfg))
    assert len(ttrain) == len(jtrain) == 3
    jit, tit = iter(jtrain), iter(ttrain)
    for _ in range(5):
        got, want = next(tit), next(jit)
        _same_sample(got, want)
        assert got["flows"].shape == (2, 2, 2, SIZE, SIZE)
    jb, tb = list(jtest), list(ttest)
    assert len(tb) == len(jb) == 3
    for got, want in zip(tb, jb):
        _same_sample(got, want)


# ---------------------------------------------------------------------------
# the results files and the configs
# ---------------------------------------------------------------------------

def test_save_results_flow_artifacts(tmp_path):
    """The port's version of `tests/test_trainer.py::
    test_save_results_flow_artifacts`: a sequence's test files include
    `_flow_gt.png` and `_flow_pred.png` (flow + 0.5, blue 0.5), and each
    is the JAX package's file byte for byte."""
    from PIL import Image
    from animals3d_tpu.utils import results_io as jresults
    from animals3d_tpu_torch.geometry.mesh import make_mesh
    from animals3d_tpu_torch.utils import results_io as tresults
    B, F, H = 1, 2, 16

    class Sh:
        v_valid = np.ones(4, bool)
        f_valid = np.ones(2, bool)
        t_pos_idx = np.zeros((2, 3), np.int32)
        v_pos = np.zeros((B * F, 4, 3), np.float32)
    batch = {"images": np.zeros((B, F, 3, H, H), np.float32),
             "masks": np.zeros((B, F, 1, H, H), np.float32),
             "flows": np.full((B, F - 1, 2, H, H), 0.25, np.float32)}
    aux = {"mask_pred": np.zeros((B, F, H, H), np.float32),
           "image_pred": np.zeros((B, F, 3, H, H), np.float32),
           "pose": np.zeros((B * F, 12), np.float32), "shape": Sh,
           "flow_pred": np.full((B, F - 1, 2, H, H), -0.25, np.float32)}
    t = lambda a: torch.from_numpy(np.asarray(a))
    taux = {k: t(v) for k, v in aux.items() if k != "shape"}
    taux["shape"] = make_mesh(t(Sh.v_pos), t(Sh.t_pos_idx).long(),
                              t(Sh.v_valid), t(Sh.f_valid), torch.tensor(4),
                              torch.tensor(2))
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jdir.mkdir()
    tdir.mkdir()
    jresults.save_results(None, batch, aux, str(jdir))
    tresults.save_results(None, {k: t(v) for k, v in batch.items()}, taux,
                          str(tdir))
    fs = sorted(os.listdir(tdir))
    assert any(f.endswith("_flow_gt.png") for f in fs)
    assert any(f.endswith("_flow_pred.png") for f in fs)
    img = np.asarray(Image.open(str(tdir / "0000000_00_flow_gt.png"))) / 255.0
    np.testing.assert_allclose(img[..., 0], 0.75, atol=0.01)
    np.testing.assert_allclose(img[..., 2], 0.5, atol=0.01)
    for n in fs:
        if "flow" in n:
            assert (jdir / n).read_bytes() == (tdir / n).read_bytes(), n


PONY_CONFIGS = [f"train_ponymation_{a}_stage{s}"
                for a in ("horse", "cow", "giraffe", "zebra") for s in (1, 2)]


@pytest.mark.parametrize("name", PONY_CONFIGS)
def test_ponymation_configs_load_as_in_jax(name):
    """The composed config (base, `dataset/sequence.yaml`,
    `model/ponymation.yaml` and the run file) equals the JAX package's
    dict for dict, but for the two keys the port's `base.yaml` names with
    the trainer's defaults (`checkpoint_path` null, `load_optim` true),
    where the run file sets neither."""
    from animals3d_tpu_torch.trainer import TrainerConfig
    got, want = tcfg.load_config(name), jcfg.load_config(name)
    for k in ("checkpoint_path", "load_optim"):
        if k not in want:
            assert got.pop(k) == getattr(TrainerConfig, k), k
    assert got == want
