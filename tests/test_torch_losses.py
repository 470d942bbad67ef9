"""The port's losses, regularizers and training-time pose sampling against
the JAX package, in float32 on the CPU, with shared weights and shared
random draws (`torch_parity.jax_noise` style: the JAX key is split as the
JAX code splits it and the port is handed the numbers)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animals3d_tpu.ops import dmtet as jdmtet
from animals3d_tpu_torch.convert_jax import export_jax_grads
from animals3d_tpu_torch.noise import Noise
from animals3d_tpu_torch.ops import dmtet as tdmtet
from animals3d_tpu_torch.precision import set_mixed_precision
from test_animal_model import TINY_OVERRIDES
from torch_parity import build_pair, flat_tree, numpy_tree, to_np

IT = 50000


@pytest.fixture(scope="module")
def pair():
    set_mixed_precision(None)
    return build_pair(TINY_OVERRIDES + [
        "+model.cfg_loss.prior_normal_reg_loss_weight=0.1"])


@pytest.fixture(scope="module")
def priors(pair):
    """The eval prior mesh and SDF of both packages (same weights)."""
    jm, jp, tm = pair
    phase = jm.phase_for_iter(IT)
    jgrid, v_cap, f_cap = jm.grid_for_phase(phase)
    jmesh, jsdf = jm.netBase.apply({"params": jp["netBase"]}, jgrid, v_cap,
                                   f_cap, IT, None)
    tgrid, _, _ = tm.grid_for_phase(tm.phase_for_iter(IT))
    tmesh, tsdf, *_ = tm.forward_base(tgrid, v_cap, f_cap)
    assert int(tmesh.num_verts) == int(jmesh.num_verts) > 50
    return jgrid, jmesh, jsdf, tgrid, tmesh, tsdf


@pytest.mark.parametrize("res,seed", [(8, 0), (12, 1)])
def test_sdf_bce_reg_loss_lattice_value_and_grad(res, seed):
    """Value rtol 1e-5; gradient with respect to the SDF atol 1e-6 (entries
    are degree/count · sigmoid, of order 1e-2)."""
    n = res + 1
    sdf = np.random.default_rng(seed).normal(0, 0.5, n ** 3) \
        .astype(np.float32)
    sdf[::17] = 0.0                       # sign(0) is its own class
    want, gwant = jax.value_and_grad(
        lambda s: jdmtet.sdf_bce_reg_loss_lattice(s, res))(jnp.asarray(sdf))
    ts = torch.from_numpy(sdf).requires_grad_(True)
    got = tdmtet.sdf_bce_reg_loss_lattice(ts, res)
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(gwant), atol=1e-6,
                               rtol=0)

    class Grid:
        is_lattice = True
    Grid.res = res
    np.testing.assert_allclose(
        float(tdmtet.sdf_bce_for_grid(ts.detach(), Grid)), float(want),
        rtol=1e-5)


def _eikonal_noise(rng, num_verts):
    k1, k2, k3 = jax.random.split(rng, 3)
    t = lambda a: torch.from_numpy(np.array(a))
    return Noise(rand_pts_u=t(jax.random.uniform(k1, (5000, 3))),
                 surf_idx=t(jax.random.randint(k2, (5000,), 0,
                                               max(int(num_verts), 1))),
                 surf_u=t(jax.random.uniform(k3, (5000, 3))))


def test_sdf_reg_losses_value_and_param_grads(pair, priors):
    """BCE and eikonal terms on shared points: values rtol 1e-5. The
    eikonal term is a gradient of a gradient: its parameter gradients
    (double backward through the harmonic embedding, the in-layer and the
    relus) agree per leaf to 1e-4 of the leaf's norm."""
    jm, jp, tm = pair
    jgrid, jmesh, jsdf, tgrid, tmesh, tsdf = priors
    rng = jax.random.PRNGKey(3)

    def jloss(p):
        out = jm.netBase.apply({"params": p}, jgrid, jsdf, jmesh, rng,
                               method="sdf_reg_losses")
        return out["sdf_gradient_reg_loss"], out
    (_, jout), jgrads = jax.value_and_grad(jloss, has_aux=True)(jp["netBase"])
    tm.zero_grad(set_to_none=True)
    tout = tm.netBase.sdf_reg_losses(
        tgrid, tsdf.detach(), tmesh,
        noise=_eikonal_noise(rng, tmesh.num_verts))
    for k in ("sdf_bce_reg_loss", "sdf_gradient_reg_loss"):
        np.testing.assert_allclose(float(tout[k]), float(jout[k]), rtol=1e-5,
                                   err_msg=k)
    tout["sdf_gradient_reg_loss"].backward()
    got = flat_tree(export_jax_grads(tm.netBase))
    want = flat_tree(numpy_tree(jgrads))
    seen = 0
    for path, leaf in want.items():
        if path[0] != "netSDF":
            continue
        if not np.any(leaf):      # the last layer's bias-free output weight
            continue
        err = np.linalg.norm(got[path] - leaf) / np.linalg.norm(leaf)
        assert err <= 1e-4, ("/".join(path), err)
        seen += 1
    assert seen >= 3
    tm.zero_grad(set_to_none=True)
    # drawn from a generator instead: finite, and different points
    gen = torch.Generator().manual_seed(0)
    drawn = tm.netBase.sdf_reg_losses(tgrid, tsdf.detach(), tmesh, gen=gen)
    assert np.isfinite(float(drawn["sdf_gradient_reg_loss"]))
    assert float(drawn["sdf_gradient_reg_loss"]) != \
        float(tout["sdf_gradient_reg_loss"])
    with pytest.raises(ValueError):
        tm.netBase.sdf_reg_losses(tgrid, tsdf.detach(), tmesh)


def _loss_inputs(seed, B=2, F=1, H=32, D=4):
    r = np.random.default_rng(seed)
    u = lambda *s: r.uniform(0, 1, s).astype(np.float32)
    mask_pred = u(B, F, H, H)
    mask_pred[:, :, :8] = 0.0
    mask_gt = (u(B, F, H, H) > 0.4).astype(np.float32)
    mask_gt[:, :, 10:24, 10:24] = 1.0
    return dict(image_pred=u(B, F, 3, H, H), image_gt=u(B, F, 3, H, H),
                mask_pred=mask_pred, mask_gt=mask_gt,
                mask_dt=u(B, F, 2, H, H) * 5,
                mask_valid=(u(B, F, H, H) > 0.1).astype(np.float32),
                dino_gt=u(B, F, D, H, H), dino_pred=u(B, F, D, H, H))


def test_compute_reconstruction_losses_values_and_grads(pair):
    """Every per-(B, F) loss rtol 1e-5 (atol 1e-7); the gradients of their
    sum with respect to the predictions atol 1e-7 (entries are ≤ 1/3072);
    the eroded intersection mask carries no gradient."""
    jm, _jp, tm = pair
    x = _loss_inputs(0)
    keys = ("image_pred", "mask_pred", "dino_pred")

    def jtotal(image_pred, mask_pred, dino_pred):
        losses = jm.compute_reconstruction_losses(
            image_pred, jnp.asarray(x["image_gt"]), mask_pred,
            jnp.asarray(x["mask_gt"]), jnp.asarray(x["mask_dt"]),
            jnp.asarray(x["mask_valid"]), None, None,
            jnp.asarray(x["dino_gt"]), dino_pred)
        return sum(v.sum() for v in losses.values()), losses
    (_, jlosses), jg = jax.value_and_grad(jtotal, argnums=(0, 1, 2),
                                          has_aux=True)(
        *(jnp.asarray(x[k]) for k in keys))
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    for k in keys:
        t[k].requires_grad_(True)
    tlosses = tm.compute_reconstruction_losses(
        t["image_pred"], t["image_gt"], t["mask_pred"], t["mask_gt"],
        t["mask_dt"], t["mask_valid"], t["dino_gt"], t["dino_pred"])
    assert set(tlosses) == set(jlosses) == {
        "mask_loss", "mask_dt_loss", "mask_inv_dt_loss", "rgb_loss",
        "dino_feat_im_loss"}
    for k, v in jlosses.items():
        assert tlosses[k].shape == v.shape == (2, 1)
        np.testing.assert_allclose(to_np(tlosses[k]), np.asarray(v),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    sum(v.sum() for v in tlosses.values()).backward()
    for k, g in zip(keys, jg):
        np.testing.assert_allclose(t[k].grad.numpy(), np.asarray(g),
                                   atol=1e-7, rtol=0, err_msg=k)
    assert jm.logit_weight("dino_feat_im_loss", IT) == \
        tm.logit_weight("dino_feat_im_loss", IT) == 500.0
    assert jm.loss_weight("mask_loss", IT) == tm.loss_weight("mask_loss", IT)


def test_mask_valid_and_mask_dt_take_pixels_out_of_the_losses(pair):
    """A check that compares two devices leaves pixels out of the losses
    through the batch: where `mask_valid` and `mask_dt` are 0 no
    prediction gets a gradient (the mask term sees mask_pred·0, the
    distance-transform terms a zero weight, the rgb and feature terms a
    zero intersection mask), and the other pixels still do."""
    _jm, _jp, tm = pair
    x = {k: torch.from_numpy(v) for k, v in _loss_inputs(1).items()}
    x["mask_valid"] = torch.ones_like(x["mask_valid"])
    x["mask_valid"][:, :, 12:20, 12:20] = 0.0
    x["mask_dt"][:, :, :, 12:20, 12:20] = 0.0
    for k in ("image_pred", "mask_pred", "dino_pred"):
        x[k].requires_grad_(True)
    losses = tm.compute_reconstruction_losses(
        x["image_pred"], x["image_gt"], x["mask_pred"], x["mask_gt"],
        x["mask_dt"], x["mask_valid"], x["dino_gt"], x["dino_pred"])
    sum(v.sum() for v in losses.values()).backward()
    assert float(x["mask_pred"].grad[:, :, 12:20, 12:20].abs().max()) == 0
    assert float(x["image_pred"].grad[:, :, :, 12:20, 12:20].abs().max()) == 0
    assert float(x["dino_pred"].grad[:, :, :, 12:20, 12:20].abs().max()) == 0
    for k in ("image_pred", "mask_pred", "dino_pred"):
        assert float(x[k].grad.abs().max()) > 0, k


def test_compute_regularizers_match_jax(pair, priors):
    """SDF terms, articulation and deformation magnitudes and the prior's
    normal consistency: rtol 1e-5 (1e-4 for the normal term, a mean over
    thousands of unit-normal dot products)."""
    jm, jp, tm = pair
    jgrid, jmesh, jsdf, tgrid, tmesh, tsdf = priors
    r = np.random.default_rng(2)
    arti = r.normal(size=(2, 1, 20, 3)).astype(np.float32)
    deform = r.normal(size=(2, 64, 3)).astype(np.float32)
    rng = jax.random.PRNGKey(9)
    want = jm.compute_regularizers(jp, jgrid, jsdf, jmesh, rng,
                                   arti_params=jnp.asarray(arti),
                                   deformation=jnp.asarray(deform))
    got = tm.compute_regularizers(
        tgrid, tsdf, tmesh, noise=_eikonal_noise(rng, tmesh.num_verts),
        arti_params=torch.from_numpy(arti),
        deformation=torch.from_numpy(deform))
    assert set(got) == set(want) == {
        "sdf_bce_reg_loss", "sdf_gradient_reg_loss", "arti_reg_loss",
        "deform_reg_loss", "prior_normal_reg_loss"}
    for k, v in want.items():
        np.testing.assert_allclose(
            float(got[k]), float(v), err_msg=k,
            rtol=1e-4 if k == "prior_normal_reg_loss" else 1e-5)


@pytest.mark.parametrize("total_iter", [3000, 7000, 50000])
def test_sample_pose_hypothesis_random_matches_jax(pair, total_iter):
    """Shared draws give exactly the JAX indices and flags at p_best 0,
    0.5 and 0.8; pose and probabilities within 1e-6."""
    jm, jp, tm = pair
    K = tm.netInstance.num_pose_hypos
    N = 64
    poses_raw = np.random.default_rng(total_iter).normal(
        size=(N, 4 * K + 3)).astype(np.float32)
    rng = jax.random.PRNGKey(total_iter)
    jpose_raw, jpose, jaux = jm.netInstance.apply(
        {"params": jp["netInstance"]}, jnp.asarray(poses_raw), total_iter,
        rng, True, method="sample_pose_hypothesis")
    k1, k2 = jax.random.split(rng)
    noise = Noise(
        rand_idx=torch.from_numpy(np.array(jax.random.randint(k1, (N,), 0,
                                                              K))),
        best_u=torch.from_numpy(np.array(jax.random.uniform(k2, (N,)))))
    pose_raw, pose, aux = tm.netInstance.sample_pose_hypothesis(
        torch.from_numpy(poses_raw), total_iter, True, noise=noise)
    np.testing.assert_array_equal(aux["rot_idx"].numpy(),
                                  np.asarray(jaux["rot_idx"]))
    np.testing.assert_array_equal(aux["rand_pose_flag"].numpy(),
                                  np.asarray(jaux["rand_pose_flag"]))
    if total_iter == 7000:
        assert 0 < int(aux["rand_pose_flag"].sum()) < N
    for k in ("rot_prob", "rot_logit", "rots_probs"):
        np.testing.assert_allclose(aux[k].numpy(), np.asarray(jaux[k]),
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(pose.numpy(), np.asarray(jpose), atol=1e-6)
    np.testing.assert_allclose(pose_raw.numpy(), np.asarray(jpose_raw),
                               atol=1e-6)
    # drawn from a generator: indices in range, flags 0/1
    _, _, drawn = tm.netInstance.sample_pose_hypothesis(
        torch.from_numpy(poses_raw), total_iter, True,
        gen=torch.Generator().manual_seed(1))
    assert int(drawn["rot_idx"].min()) >= 0 and \
        int(drawn["rot_idx"].max()) < K
    assert set(drawn["rand_pose_flag"].tolist()) <= {0, 1}
