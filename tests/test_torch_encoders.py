"""The port's CNN encoders against the JAX package on the CPU, on the same
weights carried across by `convert_jax.load_jax_params`, and the `.pth`
remaps of `convert.py` against the torchvision-shaped oracles of
`tests/torchvision_oracle.py`. float32 on both sides; the convolutions
sum in another order, so outputs are held within 1e-4 of their largest
entry (VGG's 16 layers at 224²: 1e-3)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from animals3d_tpu import convert as jconvert
from animals3d_tpu.networks import encoders as jenc
from animals3d_tpu_torch import convert as tconvert
from animals3d_tpu_torch.convert_jax import (export_jax_params,
                                             load_jax_params)
from animals3d_tpu_torch.networks import encoders as tenc
from animals3d_tpu_torch.precision import set_mixed_precision
from torch_parity import numpy_tree
import torchvision_oracle as tvo


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    set_mixed_precision(None)
    yield
    torch.set_num_threads(old)


def close(got, want, rel):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=rel * np.abs(want).max())


def flax_pair(jmod, tmod, x, seed=0, scale=None):
    """(flax params of `jmod` at `x`, loaded into `tmod`); with `scale`,
    the frozen norms' statistics are randomized (mean ± scale, var in
    [0.75, 1.25]) so that they matter."""
    params = numpy_tree(jmod.init(jax.random.PRNGKey(seed),
                                  jnp.asarray(x))["params"])
    if scale is not None:
        r = np.random.default_rng(seed)

        def walk(tree):
            for k, v in tree.items():
                if isinstance(v, dict):
                    walk(v)
                elif k == "mean":
                    tree[k] = (r.normal(size=v.shape) * scale) \
                        .astype(np.float32)
                elif k == "var":
                    tree[k] = r.uniform(0.75, 1.25, v.shape) \
                        .astype(np.float32)
        walk(params)
    load_jax_params(tmod, params)
    return params


@pytest.mark.parametrize("in_size,activation", [(64, None), (32, "tanh")])
def test_encoder_matches_jax(in_size, activation):
    x = np.random.default_rng(0).normal(size=(2, 3, in_size, in_size)) \
        .astype(np.float32)
    j = jenc.Encoder(cout=8, nf=16, in_size=in_size, activation=activation)
    t = tenc.Encoder(3, 8, in_size=in_size, nf=16, activation=activation)
    p = flax_pair(j, t, x)
    close(t(torch.from_numpy(x)), j.apply({"params": p}, jnp.asarray(x)),
          1e-4)


def test_adaptive_pool_bins_are_the_library_s():
    """For sizes the target divides, the equal windows are
    `F.adaptive_avg_pool2d`'s bins, and JAX's `_adaptive_avg_pool`."""
    x = np.random.default_rng(1).normal(size=(2, 5, 14, 20)) \
        .astype(np.float32)
    got = tenc._adaptive_avg_pool(torch.from_numpy(x[..., :14]), 7)
    want = F.adaptive_avg_pool2d(torch.from_numpy(x[..., :14]), 7)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)
    close(got, jenc._adaptive_avg_pool(
        jnp.asarray(x[..., :14]).transpose(0, 2, 3, 1), 7)
        .transpose(0, 3, 1, 2), 1e-6)
    with pytest.raises(ValueError):
        tenc._adaptive_avg_pool(torch.from_numpy(x), 7)


def test_resnet_encoders_match_jax():
    """ResnetEncoder and ResnetDepthEncoder (pooled and the layer2 tap) at
    64², frozen-norm statistics randomized; the weights round-trip through
    `export_jax_params`."""
    x = np.random.default_rng(2).uniform(0, 1, (2, 3, 64, 64)) \
        .astype(np.float32)
    j, t = jenc.ResnetEncoder(cout=6), tenc.ResnetEncoder(6)
    p = flax_pair(j, t, x, seed=1, scale=0.1)
    close(t(torch.from_numpy(x)), j.apply({"params": p}, jnp.asarray(x)),
          1e-4)
    back = export_jax_params(t)
    np.testing.assert_array_equal(back["resnet"]["layer2_0"]["downsample_bn"]
                                  ["var"], p["resnet"]["layer2_0"]
                                  ["downsample_bn"]["var"])
    jd, td = jenc.ResnetDepthEncoder(), tenc.ResnetDepthEncoder()
    pd = flax_pair(jd, td, x, seed=2, scale=0.1)
    got_g, got_l = td(torch.from_numpy(x))
    want_g, want_l = jd.apply({"params": pd}, jnp.asarray(x))
    assert got_l.shape == (2, 128, 8, 8)
    close(got_g, want_g, 1e-4)
    close(got_l, want_l, 1e-4)


def test_vgg_encoder_matches_jax():
    x = np.random.default_rng(3).normal(size=(1, 3, 224, 224)) \
        .astype(np.float32) * 0.5
    j, t = jenc.VGGEncoder(cout=7), tenc.VGGEncoder(7)
    p = flax_pair(j, t, x, seed=3)
    with torch.no_grad():
        got = t(torch.from_numpy(x))
    close(got, j.apply({"params": p}, jnp.asarray(x)), 1e-3)


def _sd(module):
    return {k: v.detach().numpy() for k, v in module.state_dict().items()}


def test_pth_remaps_match_the_torchvision_oracles():
    """The port's `convert_*` of torchvision-named state dicts equal the
    JAX package's, and the port's encoders on them give the oracles'
    outputs: ResnetEncoder and ResnetDepthEncoder at 64², VGG16's
    features at 64² (the head needs 224², held above)."""
    class RefResnetEncoder(torch.nn.Module):
        def __init__(self, cout):
            super().__init__()
            self.resnet = tvo.ResNet18()
            self.final_linear = torch.nn.Linear(512, cout)

        def forward(self, x):
            return self.final_linear(self.resnet(x)[0])

    x = np.random.default_rng(4).normal(size=(2, 3, 64, 64)) \
        .astype(np.float32)
    ref = tvo.randomize_(RefResnetEncoder(6), seed=7)
    sd = _sd(ref)
    tree = tconvert.convert_resnet_encoder(sd)
    jtree = jconvert.convert_resnet_encoder(sd)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        lambda a, b: np.array_equal(a, b), tree, jtree))
    t = tenc.ResnetEncoder(6)
    load_jax_params(t, tree)
    with torch.no_grad():
        want = ref(torch.from_numpy(x))
        got = t(torch.from_numpy(x))
    close(got, want.numpy(), 1e-4)

    depth_sd = {k: v for k, v in sd.items() if k.startswith("resnet.")}
    td = tenc.ResnetDepthEncoder()
    load_jax_params(td, tconvert.convert_resnet_depth_encoder(depth_sd))
    mean = torch.tensor(tenc._IMAGENET_MEAN)[:, None, None]
    std = torch.tensor(tenc._IMAGENET_STD)[:, None, None]
    with torch.no_grad():
        want_g, want_l = ref.resnet((torch.from_numpy(x) - mean) / std)
        got_g, got_l = td(torch.from_numpy(x))
    close(got_g, want_g.numpy(), 1e-4)
    close(got_l, want_l.numpy(), 1e-4)

    vgg = tvo.randomize_(tvo.VGG16(), seed=5)
    feats = tenc.VGG16Features()
    load_jax_params(feats, tconvert.convert_vgg16_features(_sd(vgg)))
    with torch.no_grad():
        want = vgg.features(torch.from_numpy(x))
        got = feats(torch.from_numpy(x))
    close(got, want.numpy(), 1e-4)
