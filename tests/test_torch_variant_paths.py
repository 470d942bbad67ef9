"""The render selectors at the model level, on the CPU at the tiny sizes of
`tests/torch_parity.py`: `AnimalModel(..., raster_variant=4)` and
`AnimalModel(..., raster_variant=6, resolve_rows="kernel")` (the JAX
package's `A3D_RASTER_V=4`, `A3D_RASTER_V=6` and `A3D_MXU_FWD=1`) against
the default path, from the same weights. On the CPU every kernel runs its
plain version; variants 4 and 6 compute variant 3's z and face_id (on
these meshes no face's depth falls below its unit's z-min bound, where the
per-unit skip of variant 6 may keep another winner), and the kernel rows
the gather rows, so the paths agree bit for bit."""
import numpy as np
import pytest
import torch

from animals3d_tpu_torch import config as tcfg
from animals3d_tpu_torch.models import build_model
from animals3d_tpu_torch.ops import rasterize_cuda as rc
from animals3d_tpu_torch.ops import resolve_cuda as rv
from animals3d_tpu_torch.precision import set_mixed_precision
from test_animal_model import TINY_OVERRIDES
from torch_parity import TRAIN_OVERRIDES, batch_to, fake_batch_np

IT = 50000
PATHS = {"v4": dict(raster_variant=4),
         "v6_kernel_rows": dict(raster_variant=6, resolve_rows="kernel")}


def _models(overrides):
    set_mixed_precision(None)
    cfg = tcfg.load_config("train_magicpony_horse", overrides=overrides)
    cfg["model"]["dataset"] = cfg["dataset"]
    base = build_model(cfg["model"], device="cpu")
    state = base.init_params(0)
    others = {}
    for name, kw in PATHS.items():
        m = build_model(cfg["model"], device="cpu", **kw)
        m.load_state_dict(state)
        others[name] = m
    return base, others


def _recon(m):
    images = torch.from_numpy(np.random.default_rng(1).uniform(
        0, 1, (2, 1, 3, 64, 64)).astype(np.float32))
    return m.reconstruct(m, images, IT)


def _train(m):
    """Loss, metrics and gradients of one training forward and backward,
    with the draws of one seed."""
    batch = batch_to(fake_batch_np(0), torch.from_numpy)
    m.zero_grad(set_to_none=True)
    loss, (met, _aux) = m.forward(batch, IT, torch.Generator().manual_seed(3))
    loss.backward()
    grads = {n: p.grad for n, p in m.named_parameters()}
    m.zero_grad(set_to_none=True)
    return loss.detach(), met, grads


@pytest.fixture(scope="module")
def recon_models():
    base, others = _models(TINY_OVERRIDES)
    return _recon(base), others


@pytest.fixture(scope="module")
def train_models():
    base, others = _models(TRAIN_OVERRIDES)
    return _train(base), others


@pytest.mark.parametrize("path", sorted(PATHS))
def test_reconstruct_equals_default_path(recon_models, path):
    """`reconstruct` through the variant's plain versions: the shaded RGBA
    and the instance predictor's outputs identical to the default path's;
    no kernel launch is counted on the CPU."""
    (want, wout), others = recon_models
    launches = (rc.visibility_v4.launches, rc.visibility_v6.launches,
                rv.resolve_fwd.launches)
    got, out = _recon(others[path])
    assert launches == (rc.visibility_v4.launches, rc.visibility_v6.launches,
                        rv.resolve_fwd.launches)
    assert float((want[:, 3] > 0).float().mean()) > 0.01
    assert torch.equal(got, want)
    for a, b in zip(out[1:11], wout[1:11]):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_train_step_loss_and_gradients_equal_default_path(train_models,
                                                          path):
    """One training forward and backward (the iter-50000 phase, draws from
    one seed for both): the loss, every metric and every parameter's
    gradient identical to the default path's."""
    (l0, m0, g0), others = train_models
    l1, m1, g1 = _train(others[path])
    assert torch.equal(l0, l1)
    for k in m0:
        assert torch.equal(torch.as_tensor(m0[k]), torch.as_tensor(m1[k])), k
    assert sum(g is not None for g in g0.values()) > 40
    for n, g in g0.items():
        assert (g is None) == (g1[n] is None), n
        assert g is None or torch.equal(g, g1[n]), n


def test_model_rejects_unknown_selectors():
    cfg = tcfg.load_config("train_magicpony_horse", overrides=TINY_OVERRIDES)
    cfg["model"]["dataset"] = cfg["dataset"]
    for kw in (dict(raster_variant=5), dict(resolve_rows="mxu")):
        with pytest.raises(ValueError):
            build_model(cfg["model"], device="cpu", **kw)
