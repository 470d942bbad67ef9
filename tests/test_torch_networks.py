"""Port parity of the networks MagicPony runs, and of the image ops: each
flax module and its PyTorch counterpart on the same numpy inputs, with
the flax init weights carried across by `load_jax_params`. Forward in
float32, atol 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animals3d_tpu.networks import articulation as jart
from animals3d_tpu.networks import encoders as jenc
from animals3d_tpu.networks import mlp as jmlp
from animals3d_tpu.networks import vit as jvit
from animals3d_tpu.ops import image as jimage
from animals3d_tpu_torch.convert_jax import load_jax_params
from animals3d_tpu_torch.networks import articulation as tart
from animals3d_tpu_torch.networks import encoders as tenc
from animals3d_tpu_torch.networks import mlp as tmlp
from animals3d_tpu_torch.networks import vit as tvit
from animals3d_tpu_torch.ops import image as timage
from animals3d_tpu_torch.precision import set_mixed_precision
from torch_parity import numpy_tree

ATOL = 1e-5
SCALAR = 2 * np.pi / 5.0 * 0.9


@pytest.fixture(autouse=True)
def _float32():
    set_mixed_precision(None)
    yield
    set_mixed_precision(None)


def _inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, s).astype(np.float32) for s in shapes]


def _run_both(jmod, tmod, *inputs):
    """Init the flax module, carry its weights into the port module and
    run both on `inputs`."""
    jin = [jnp.asarray(x) for x in inputs]
    params = jmod.init(jax.random.PRNGKey(0), *jin)["params"]
    load_jax_params(tmod, numpy_tree(params))
    want = jmod.apply({"params": params}, *jin)
    with torch.no_grad():
        got = tmod(*[torch.from_numpy(x) for x in inputs])
    return want, got


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("n,scalar", [(10, 1.0), (8, SCALAR)])
def test_harmonic_embedding(n, scalar):
    (x,) = _inputs(0, (4, 7, 3))
    want = jmlp.harmonic_embedding(jnp.asarray(x), n, scalar)
    got = tmlp.harmonic_embedding(torch.from_numpy(x), n, scalar)
    _close(got, want)


def test_mlp():
    x, = _inputs(1, (3, 5, 16))
    want, got = _run_both(jmlp.MLP(3, 3, 32, "sigmoid"),
                          tmlp.MLP(16, 3, 3, 32, "sigmoid"), x)
    _close(got, want)


def test_mlp_split_first_layer():
    """The per-image feature folded into layer_0 keeps the fused layer's
    (dx + df, out) parameter layout."""
    x, feat = _inputs(2, (2, 6, 16), (2, 8))
    want, got = _run_both(jmlp.MLP(4, 2, 32),
                          tmlp.MLP(16, 4, 2, 32, split_dim=8), x, feat)
    _close(got, want)


@pytest.mark.parametrize("conditioned", [False, True])
def test_coord_mlp(conditioned):
    """The texture-net shape: symmetrized harmonic input, in-layer ReLU,
    min-max output; with and without a conditioning feature."""
    mm = tuple((0.0, 1.0 + 0.1 * i) for i in range(9))
    kw = dict(num_layers=3, nf=32, activation="sigmoid", min_max=mm,
              n_harmonic_functions=10, embedder_scalar=SCALAR,
              embed_concat_pts=True, symmetrize=True, in_layer_relu=True,
              extra_feat_dim=8 if conditioned else 0)
    x, feat = _inputs(3, (2, 5, 6, 3), (2, 8))
    args = (x, feat) if conditioned else (x,)
    want, got = _run_both(jmlp.CoordMLP(3, 9, **kw),
                          tmlp.CoordMLP(3, 9, **kw), *args)
    _close(got, want)


def test_dino_vit_depth2():
    """Two blocks with the key block last; a 4×4 patch grid exercises the
    bicubic resize of the 28×28 position embeddings."""
    x, = _inputs(4, (2, 3, 32, 32))
    want, got = _run_both(jvit.DinoViT(depth=2, key_block=1),
                          tvit.DinoViT(depth=2, key_block=1), x)
    _close(got[0], want[0])
    _close(got[1], want[1])


def test_encoder32():
    x, = _inputs(5, (2, 24, 32, 32))
    want, got = _run_both(jenc.Encoder32(7, nf=16),
                          tenc.Encoder32(24, 7, 32, nf=16), x)
    _close(got, want)


@pytest.mark.parametrize("net_type", ["mlp", "attention"])
def test_articulation_network(net_type):
    kw = dict(num_layers=2, nf=16, n_harmonic_functions=4,
              embedder_scalar=np.pi * 0.9, enable_articulation_idadd=True)
    x, pos = _inputs(6, (2, 20, 12), (2, 20, 9))
    want, got = _run_both(jart.ArticulationNetwork(net_type, 12, 9, **kw),
                          tart.ArticulationNetwork(net_type, 12, 9, **kw),
                          x, pos)
    _close(got, want)


def test_grid_sample_bilinear():
    """Bilinear sampling with zero padding, points inside and outside."""
    feat, coords = _inputs(7, (2, 5, 8, 12), (2, 3, 7, 2))
    coords = coords * 1.2
    want = jimage.grid_sample_bilinear(jnp.asarray(feat), jnp.asarray(coords))
    got = timage.grid_sample_bilinear(torch.from_numpy(feat), torch.from_numpy(coords))
    _close(got, want)


@pytest.mark.parametrize("size", [(24, 20), (5, 7)])
def test_resize_nchw(size):
    """Bilinear resize, up and (antialiased) down."""
    x, = _inputs(8, (2, 3, 12, 14))
    want = jimage.resize_nchw(jnp.asarray(x), size)
    got = timage.resize_nchw(torch.from_numpy(x), size)
    _close(got, want)
