"""The port's Ponymation against the JAX package, on the CPU in float32.

Models: `train_ponymation_horse_stage{1,2}` at `tests/test_ponymation.py`'s
`TINY_PONY` widths (64², grid 8, VAE latent 32 with one transformer
layer), the flax init tree carried over with `convert_jax`.

  * the motion VAE: `ArticulationVAE`'s forward given ε and `sample`
    given z at latent 32 and one and two layers, rtol 1e-5; the
    reference `.pth` remap of `convert.py` against the JAX package's
    `convert_motion_vae`;
  * `render_mesh` at spp 2 (a 32² image from 64² visibility) for
    `shaded`, `dino_pred` and `flow`: the outputs, and the gradients
    into the vertices at the pixels both packages rasterize alike;
  * stage 1 at iteration 100,000 (coarse grid, deformation, attached
    legs, the articulation regularizer; one sequence of 3 frames with
    flows, the flow loss weighted 1): loss and metrics at rtol 1e-4, the
    smoothness and flow terms among them, and the `netArticulation`
    gradient leaves within `tests/test_torch_train.py`'s `GRAD_TOL`; the
    key is searched as there (`search_here` in a child process: feet,
    faces, blend branches, texture ReLU ties);
  * stage 2 (render off): `arti_recon_loss`, `kld_loss`, the other
    metrics and the `netVAE` gradient leaves, on the first key whose
    articulation agrees within 1e-4 (the feet);
  * `generate` (stage 2's eval forward): shapes, generated angles and the
    mask rendered from the default camera;
  * one Adam step of each stage: every frozen parameter unchanged bit for
    bit, the trained net's entries within 2% of a first Adam update
    wherever the gradient is clear of rounding (`_adam_step_matches`);
    and the step count of a parameter without gradient, against optax;
  * the frozen netDeform evaluated in chunks of whole frames;
  * stage 1's `Trainer.train` and `Trainer.test` on a synthetic sequence
    tree with flows, writing `_flow_gt.png` and `_flow_pred.png`.

The file runs on two torch threads (as `tests/test_torch_trainer.py`):
the suite runs six pytest workers, and torch's spinning OpenMP threads
slow a port forward by two orders of magnitude under them.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from animals3d_tpu import convert as jconvert
from animals3d_tpu.geometry import tets as jtets
from animals3d_tpu.networks import motion_vae as jvae
from animals3d_tpu.ops import rasterize as jrz
from animals3d_tpu.render.camera import xfm_points as jxfm
from animals3d_tpu.render.render import render_mesh as jrender
from animals3d_tpu.trainer import make_optimizer as jmake_optimizer
from animals3d_tpu_torch import convert as tconvert
from animals3d_tpu_torch.convert_jax import (export_jax_params,
                                             load_jax_params)
from animals3d_tpu_torch.networks import motion_vae as tvae
from animals3d_tpu_torch.ops import rasterize_cuda as rc
from animals3d_tpu_torch.precision import set_mixed_precision
from animals3d_tpu_torch.render.camera import xfm_points as txfm
from animals3d_tpu_torch.render.render import render_mesh as trender
from animals3d_tpu_torch.trainer import make_optimizer, train_step
from test_ponymation import TINY_PONY
from test_torch_render import _port_mesh
from test_torch_train import GRAD_TOL, Pair, search_steps
from torch_parity import (_grow, _silhouette_pairs, assert_images_close,
                          assert_same_visibility, batch_to, build_pair,
                          fake_batch_np, flat_tree, jax_noise, numpy_tree,
                          to_np)

STAGE1 = "train_ponymation_horse_stage1"
STAGE2 = "train_ponymation_horse_stage2"
IT = 100000
B, F = 1, 3          # stage 1: one sequence (each image must pass the search)
# stage 1 renders and weighs the flow, so that its gradient is held too
STAGE1_OVERRIDES = TINY_PONY + ["dataset.batch_size=1",
                                "model.cfg_render.render_flow=true",
                                "+model.cfg_loss.flow_loss_weight=1.0"]
RTOL = 1e-5          # the modules
DARK = 0.1           # `tests/test_torch_train.py`'s dark targets


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, rtol=RTOL, atol=1e-6):
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=rtol,
                               atol=atol)


# ---------------------------------------------------------------------------
# the motion VAE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layers", [1, 2])
def test_articulation_vae_matches_jax(layers):
    """Forward on (B·F, J, feat) inputs given the same ε (mu, logvar and
    the decoded angles) and `sample` given the same z, within 1e-5
    relative: rtol 1e-5, and atol 1e-5 of the output's largest entry
    (1.7e-6 of 0.70 seen at two layers, on an angle near 0); the port's
    parameter names are the flax tree's (`load_jax_params` is strict)."""
    set_mixed_precision(None)
    Bv, Fv, J, feat, D = 2, 4, 20, 48, 32
    kw = dict(njoints=J, feat_dim=feat, latent_dim=D,
              transformer_layer_num=layers)
    r = np.random.default_rng(layers)
    x = r.normal(size=(Bv * Fv, J, feat)).astype(np.float32)
    pos = r.uniform(-1, 1, (Bv * Fv, J, 9)).astype(np.float32)
    jm = jvae.ArticulationVAE(**kw)
    params = jm.init({"params": jax.random.PRNGKey(0)}, x, pos, Fv, Bv,
                     jax.random.PRNGKey(1))["params"]
    tm = tvae.ArticulationVAE(**kw)
    load_jax_params(tm, numpy_tree(params))
    key = jax.random.PRNGKey(2)
    want = jm.apply({"params": params}, x, pos, Fv, Bv, key)
    eps = jax.random.normal(key, (1, Bv, D))
    with torch.no_grad():
        got = tm(t(x), t(pos), Fv, Bv, t(eps))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        close(g, w, atol=RTOL * float(np.abs(w).max()))
    zk = jax.random.PRNGKey(3)
    want = jm.apply({"params": params}, zk, 1, 10, method="sample")
    with torch.no_grad():
        got = tm.sample(t(jax.random.normal(zk, (1, 1, D))), 10)
    assert got.shape == (1, 10, J, 3)
    close(got, want, atol=RTOL * float(np.abs(want).max()))


def _reference_vae_state(D, layers, feat_in):
    """A state dict in the reference's layout (`MotionVAE.py:130-222`),
    from torch's own transformer layers, with random values."""
    from torch import nn
    gen = torch.Generator().manual_seed(0)

    class Enc(nn.Module):
        def __init__(self):
            super().__init__()
            self.boneFeatQuery = nn.Parameter(torch.randn(1, 1, D,
                                                          generator=gen))
            self.muQuery = nn.Parameter(torch.randn(1, 1, D, generator=gen))
            self.sigmaQuery = nn.Parameter(torch.randn(1, 1, D,
                                                       generator=gen))
            self.skelEmbedding = nn.Linear(D, D)
            layer = lambda: nn.TransformerEncoderLayer(D, 4, 1024)
            self.boneTransEncoder = nn.TransformerEncoder(
                layer(), layers, enable_nested_tensor=False)
            self.seqTransEncoder = nn.TransformerEncoder(
                layer(), layers, enable_nested_tensor=False)

    class Dec(nn.Module):
        def __init__(self):
            super().__init__()
            layer = lambda: nn.TransformerDecoderLayer(D, 4, 1024)
            self.seqTransDecoder = nn.TransformerDecoder(layer(), layers)
            self.boneTransDecoder = nn.TransformerDecoder(layer(), layers)
            self.finallayer = nn.Linear(D, 3)

    class VAE(nn.Module):
        def __init__(self):
            super().__init__()
            self.in_layer = nn.Sequential(nn.Linear(feat_in, D), nn.GELU(),
                                          nn.LayerNorm(D))
            self.encoder = Enc()
            self.decoder = Dec()
    vae = VAE()
    with torch.no_grad():
        for p in vae.parameters():
            p.copy_(torch.randn(p.shape, generator=gen))
    return {k: v.numpy() for k, v in vae.state_dict().items()}


def test_reference_vae_remap_matches_jax():
    """`convert.convert_motion_vae` on a reference-layout state dict (the
    packed `in_proj_weight` of torch's `MultiheadAttention` split into
    q, k and v) gives the JAX package's tree, array for array, and loads
    into the port's VAE with every parameter set."""
    D, layers, feat_in = 32, 2, 48 + 9 * 17
    sd = _reference_vae_state(D, layers, feat_in)
    want = flat_tree(jconvert.convert_motion_vae(sd, layers))
    got = flat_tree(tconvert.convert_motion_vae(sd, layers))
    assert set(got) == set(want) and len(got) > 50
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg="/".join(k))
    tm = tvae.ArticulationVAE(njoints=20, feat_dim=48, latent_dim=D,
                              transformer_layer_num=layers)
    load_jax_params(tm, tconvert.convert_motion_vae(sd, layers))
    np.testing.assert_array_equal(
        tm.encoder.bone_1.self_attn.k.weight.detach().numpy(),
        sd["encoder.boneTransEncoder.layers.1.self_attn.in_proj_weight"][
            D:2 * D])


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stage1():
    """(JAX model, its init params, port model with the same weights) of
    stage 1."""
    set_mixed_precision(None)
    return build_pair(STAGE1_OVERRIDES, STAGE1, (0, IT))


@pytest.fixture(scope="module")
def stage2():
    set_mixed_precision(None)
    return build_pair(TINY_PONY, STAGE2, (0, IT))


def test_frozen_params_and_cameras_match_jax(stage1, stage2):
    """`frozen_param` on every leaf of each stage's tree (stage 1 trains
    only netArticulation, stage 2 only netVAE), the port's parameters
    without gradient exactly the frozen ones, and the default camera
    (−120° about y, `offset_extra` further away) at rtol 1e-6."""
    for jm, jp, tm in (stage1, stage2):
        trained = set()
        for path in flat_tree(numpy_tree(jp)):
            frozen = jm.frozen_param(list(path))
            assert tm.frozen_param(list(path)) == frozen, path
            if not frozen and "ViT" not in path:
                trained.add(path[1])
        assert trained == {"netVAE" if jm.enable_motion_vae
                           else "netArticulation"}
        for n, p in tm.named_parameters():
            assert p.requires_grad == (not tm.frozen_param(n.split("."))
                                       and ".ViT." not in n), n
    jm, _jp, tm = stage2
    for got, want in zip(tm.default_cameras(3), jm.default_cameras(3)):
        close(got, want, rtol=1e-6, atol=1e-6)


def test_frozen_deformation_in_chunks_equals_whole(stage2, monkeypatch):
    """netDeform runs in chunks of whole images (`DEFORM_ROWS`; 200 frames
    at full width would hold 18.75 GiB an activation in float32): the
    offsets, and under autograd the gradient into the features, equal one
    whole evaluation's within float32 rounding (1e-6 of the largest; a
    matrix product's blocking follows its row count)."""
    from animals3d_tpu_torch.predictors import motion_vae as pmv
    _jm, _jp, tm = stage2
    inst = tm.netInstance
    r = np.random.default_rng(4)
    verts = t(r.normal(size=(1, 500, 3)).astype(np.float32)).expand(7, 500,
                                                                   3)
    feat = t(r.normal(size=(7, 32)).astype(np.float32)).requires_grad_(True)
    cot = t(r.normal(size=(7, 500, 3)).astype(np.float32))
    whole = inst.netDeform(verts, feat)
    g_whole, = torch.autograd.grad((whole * cot).sum(), feat)
    monkeypatch.setattr(pmv, "DEFORM_ROWS", 1000)          # 2 images a chunk
    rows = []
    real = inst.netDeform.forward
    monkeypatch.setattr(inst.netDeform, "forward",
                        lambda v, f: rows.append(v.shape[0]) or real(v, f))
    chunked = inst._deform_offsets(verts, feat)
    g_chunked, = torch.autograd.grad((chunked * cot).sum(), feat)
    assert rows == [2, 2, 2, 1]
    assert chunked.shape == whole.shape
    assert float((chunked - whole).detach().abs().max()) <= \
        1e-6 * float(whole.detach().abs().max())
    assert float((g_chunked - g_whole).abs().max()) <= \
        1e-6 * float(g_whole.abs().max())


# ---------------------------------------------------------------------------
# render_mesh at spp 2 with flow
# ---------------------------------------------------------------------------

def test_render_spp2_with_flow_matches_jax(stage1):
    """The prior mesh (grid 16) of the stage-1 model seen by two cameras
    as one 2-frame sequence, 32² at spp 2 (64² visibility), shaded with
    the texture field and a light, with DINO features and flow: the
    outputs, and the gradient of a
    random weighting of all three with respect to the posed vertices
    within `GRAD_TOL` of its norm, taken at the output pixels away from
    any visibility pixel whose face differs between the two packages.
    Both rasts hold `assert_same_visibility`'s tie check; the outputs are
    held at atol 1e-4, and 1e-3 at the pixels of silhouette pairs, away
    from flipped faces (`assert_images_close`'s limits, judged on each
    output pixel's 2×2 block of visibility pixels)."""
    set_mixed_precision(None)
    jm, jp, tm = stage1
    H, spp = 32, 2
    # the prior on a grid-16 lattice (the models' own is 8)
    v_cap, f_cap = jtets.default_capacity(16, 6.0)
    prior, _ = jm.netBase.apply(
        {"params": jp["netBase"]},
        jtets.DeviceTetGrid(jtets.load_tet_grid(16)), v_cap, f_cap, 0, None)
    ang = np.asarray([0.4, 0.55], np.float32)
    c, s = np.cos(ang), np.sin(ang)
    z, o = np.zeros_like(ang), np.ones_like(ang)
    rot = np.stack([c, z, s, z, o, z, -s, z, c], -1)
    pose = np.concatenate([rot, np.asarray([[0.1, -0.2, 0.3],
                                            [0.05, -0.15, 0.2]])], -1)
    mvp, w2c, campos = (to_np(a) for a in
                        tm.netInstance.get_camera_extrinsics_from_pose(
                            torch.from_numpy(pose.astype(np.float32))))
    r = np.random.default_rng(7)
    feat = r.uniform(-1, 1, (2, 32)).astype(np.float32)
    ldir = r.normal(size=(2, 3))
    ldir /= np.linalg.norm(ldir, axis=-1, keepdims=True)
    light = np.concatenate([ldir, np.full((2, 1), 0.3), np.full((2, 1), 0.6)],
                           -1).astype(np.float32)
    modes = ["shaded", "dino_pred", "flow"]
    v_pos = np.broadcast_to(np.asarray(prior.v_pos),
                            (2, *prior.v_pos.shape[1:])).copy()
    shapes = {"shaded": (2, 4, H, H), "dino_pred": (2, 4, H, H),
              "flow": (2, 2, H, H)}
    weights = {k: r.normal(size=v).astype(np.float32)
               for k, v in shapes.items()}

    def jax_out(vp):
        mesh = dataclasses.replace(prior.extend(2), v_pos=vp)
        material = lambda p_: jm.netInstance.apply(
            {"params": jp["netInstance"]}, p_, jnp.asarray(feat),
            method="sample_texture")
        dino = lambda p_: jm.netBase.apply(
            {"params": jp["netBase"]}, p_, None, method="dino_field")
        return jrender(mesh, jnp.asarray(mvp), jnp.asarray(w2c),
                       jnp.asarray(campos), (H, H), material_fn=material,
                       light_params=jnp.asarray(light), spp=spp,
                       render_modes=modes, prior_mesh=prior, dino_fn=dino,
                       num_frames=2)
    tprior = _port_mesh(prior)
    tv = t(v_pos).requires_grad_(True)
    tmesh = dataclasses.replace(tprior.extend(2), v_pos=tv)
    got = trender(tmesh, t(mvp), t(w2c), t(campos), (H, H),
                  material_fn=lambda p_: tm.netInstance.sample_texture(
                      p_, t(feat)),
                  light_params=t(light), spp=spp, render_modes=modes,
                  prior_mesh=tprior,
                  dino_fn=lambda p_: tm.netBase.dino_field(p_),
                  num_frames=2)
    full = (H * spp, H * spp)
    with torch.no_grad():
        v_clip = txfm(tv.detach(), t(mvp))
        rast = rc.rasterize_cuda(v_clip, tprior.t_pos_idx, tprior.f_valid,
                                 full, v_pos0=tv.detach()[0])
    jclip = jxfm(jnp.asarray(v_pos), jnp.asarray(mvp))
    jrast = jrz.rasterize(jclip, prior.t_pos_idx, prior.f_valid, full)
    fid, jfid = to_np(rast.face_id), np.asarray(jrast.face_id)
    z, jz = to_np(rast.z), np.asarray(jrast.z)
    assert (fid > 0).sum() > 400
    assert_same_visibility(fid, jfid, z, jz, to_np(v_clip),
                           to_np(tprior.t_pos_idx), z_atol=1e-3,
                           max_share=0.001)

    def pool(m):                       # (2, 64, 64) → (2, 32, 32): any
        return m.reshape(2, H, spp, H, spp).any((2, 4))
    near = pool(_grow(fid != jfid))
    sil = pool(_silhouette_pairs(fid, z) | _silhouette_pairs(jfid, jz))
    # JAX's outputs and its gradient of the weighting, in one compile,
    # away from the visibility pixels whose face differs
    keep = {k: (w * ~pool(_grow(_grow(fid != jfid)))[:, None])
            .astype(np.float32) for k, w in weights.items()}

    def jtotal(vp):
        out = jax_out(vp)
        return sum((out[k] * keep[k]).sum() for k in modes), out
    (_, want), jg = jax.jit(jax.value_and_grad(jtotal, has_aux=True))(
        jnp.asarray(v_pos))
    jg = np.asarray(jg)
    for k in modes:
        assert tuple(got[k].shape) == tuple(want[k].shape) == shapes[k], k
        g, w = to_np(got[k].detach()), np.asarray(want[k])
        for m, tol in ((~near & ~sil, 1e-4), (~near & sil, 1e-3)):
            sel = np.broadcast_to(m[:, None], g.shape)
            np.testing.assert_allclose(g[sel], w[sel], atol=tol, rtol=0,
                                       err_msg=k)
    assert float(np.abs(to_np(got["flow"].detach())).max()) > 1e-3
    sum((got[k] * t(keep[k])).sum() for k in modes).backward()
    gap = np.linalg.norm(tv.grad.numpy() - jg) / np.linalg.norm(jg)
    assert gap <= GRAD_TOL, (gap, int(near.sum()))
    assert np.linalg.norm(jg) > 0


# ---------------------------------------------------------------------------
# stage 1: the training forward
# ---------------------------------------------------------------------------

class PonyPair(Pair):
    """`tests/test_torch_train.py`'s `Pair` on the stage-1 models at `IT`,
    on one dark sequence of `F` frames with flows in [-0.05, 0.05)."""

    def __init__(self, it=IT, overrides=STAGE1_OVERRIDES, models=None):
        models = models or build_pair(overrides, STAGE1, (0, it))
        super().__init__(it, overrides, models=models, batch_size=B)
        self.batch = fake_batch_np(0, B=B, F=F)
        for k in ("images", "dino_features"):
            self.batch[k] = (self.batch[k] * DARK).astype(np.float32)
        self.batch["flows"] = np.random.default_rng(1).uniform(
            -0.05, 0.05, (B, F - 1, 2, 64, 64)).astype(np.float32)
        self.jbatch = batch_to(self.batch, jnp.asarray)
        self.tbatch = batch_to(self.batch, torch.from_numpy)

    def noise(self, rng):
        """The draws of the forward over its B·F images."""
        K = self.tm.netInstance.num_pose_hypos
        first = jax_noise(rng, B * F, K)
        grid, v_cap, f_cap = self.tm.grid_for_phase(self.tphase)
        with torch.no_grad():
            prior, *_ = self.tm.forward_base(grid, v_cap, f_cap,
                                             jitter=first.jitter_u)
        return jax_noise(rng, B * F, K, int(prior.num_verts))


def child_search(its, overrides):
    """`search_here` on a `PonyPair` (the child of `torch_search` calls
    this)."""
    from test_torch_train import search_here
    out = {}
    for it in its:
        pair = PonyPair(it, overrides)
        try:
            out[it] = (search_here(pair), pair.tie_keys, pair.relu_keys)
        except pytest.fail.Exception as e:
            out[it] = f"iteration {it}: {e}"
    return out


@pytest.fixture(scope="module")
def pair(stage1):
    return PonyPair(models=stage1)


@pytest.fixture(scope="module")
def step(pair):
    s = search_steps({IT: pair}, "test_torch_ponymation")[IT]
    if isinstance(s, str):
        pytest.fail(s)
    print(f"stage 1, iteration {IT}: key {s['seed']}")
    return s


def _trained_gaps(tgrads, jgrads, net):
    """{path: |Δ| / ‖leaf‖} over the leaves of `net`; the port's tree
    holds exactly those. The leaves whose gradient is zero in exact
    arithmetic are held to zero instead, within 1e-6 of the net's largest
    leaf norm in both packages: every attention's key bias (it adds one
    constant to a query's logits over all keys, which the softmax
    ignores; 1.4e-8 against 17.1 seen) and the cross-attention's key
    weights over one z token (a softmax over one key is 1)."""
    got, want = flat_tree(tgrads), flat_tree(numpy_tree(jgrads))
    assert {p[1] for p in got} == {net}
    want = {p: v for p, v in want.items() if p[:2] == ("netInstance", net)}
    assert set(got) == set(want) and len(want) > 5
    scale = max(np.linalg.norm(v) for v in want.values())
    gaps = {}
    for p, leaf in want.items():
        assert np.isfinite(got[p]).all(), p
        norm = np.linalg.norm(leaf)
        if norm == 0 or p[-2:] == ("k", "bias"):
            assert max(np.abs(got[p]).max(), np.abs(leaf).max()) \
                <= 1e-6 * scale, p
            continue
        gaps[p] = np.linalg.norm(got[p] - leaf) / norm
    assert len(gaps) > 5
    return gaps


def test_stage1_forward_matches_jax(pair, step):
    """The phase (coarse grid, deformation on, legs attached, no random
    pose), the decisions (pose hypothesis, articulation within 1e-4), the
    loss and every metric at rtol 1e-4, the sequence smoothness terms and
    the flow loss among them."""
    ph = pair.phase
    assert ph.use_coarse_grid and ph.deform_on and ph.articulation_on \
        and ph.attach_legs
    jaux, taux = step["jaux"], step["taux"]
    np.testing.assert_array_equal(np.asarray(jaux["rot_idx"]),
                                  taux["rot_idx"].numpy())
    close(taux["arti_params"], jaux["arti_params"], rtol=0, atol=1e-4)
    assert set(step["tmet"]) == set(step["jmet"])
    for name in ("campose_smooth_loss", "artivel_smooth_loss", "flow_loss",
                 "arti_reg_loss", "deform_reg_loss"):
        assert name in step["tmet"], name
    for name, want in step["jmet"].items():
        np.testing.assert_allclose(float(step["tmet"][name]), float(want),
                                   rtol=1e-4, err_msg=name)
    np.testing.assert_allclose(float(step["tloss"]), float(step["jloss"]),
                               rtol=1e-4)
    assert float(step["tmet"]["flow_loss"]) > 0
    close(taux["flow_pred"], jaux["flow_pred"], rtol=0, atol=1e-3)


def test_stage1_gradients_match_jax(step):
    """Only `netArticulation` has gradients in the port (every other
    parameter is frozen and kept without gradient); each of its leaves
    within `GRAD_TOL` of the JAX leaf's norm."""
    gaps = _trained_gaps(step["tgrads"], step["jgrads"], "netArticulation")
    bad = {"/".join(p): g for p, g in gaps.items() if g > GRAD_TOL}
    assert not bad, bad


# the least share of a trained leaf's entries whose gradient is clear of
# rounding, for every leaf whose JAX gradient reaches 1e-6
MIN_CLEAR_SHARE = 0.5


def _adam_step_matches(jm, jp, tm, jgrads, tgrads, run_step, net,
                       opt_names):
    """One step of each package's optimizer from the same weights: every
    frozen leaf bit for bit unchanged in both, and `net`'s entries within
    2.1e-4 of JAX's (a first Adam update of lr 1e-4 is lr·g/(|g| + 1e-8));
    within 2e-6 (2% of an update) wherever JAX's gradient is clear of
    rounding, |g| > max(1e-6, 10 × the leaf's largest gap between the two
    packages' gradients), as `chip_smoke.py`'s reference step holds the
    card to the CPU. Every leaf whose JAX gradient reaches 1e-6 has at
    least `MIN_CLEAR_SHARE` of its entries clear, so the 2e-6 bound checks
    the learning rate and the bias correction on each (smallest share
    seen: 0.733 in stage 1, netArticulation's qkv kernel; 0.663 in stage
    2, the decoder's first sequence self-attention key kernel); the leaves
    below 1e-6 (the attention key biases, and the query and key of a
    cross-attention over one token) have no gradient in exact arithmetic.
    `test_torch_train.py`'s rule (at most 1% of a leaf's
    entries off) does not hold here: the VAE's attention leaves have
    hundreds of entries at ~1e-9 by construction (a key weight's rows
    along an input direction the same for all tokens, such as the slow
    columns of the positional encoding, get no gradient in exact
    arithmetic; 345 of 1,024 below 1e-6 in the decoder's first
    self-attention), where the update is any value within ±lr."""
    tx = jmake_optimizer(jm, jp)
    updates, _ = tx.update(jgrads, tx.init(jp), jp)
    want = flat_tree(numpy_tree(optax.apply_updates(jp, updates)))
    init = flat_tree(numpy_tree(jp))
    grads, tgrads = flat_tree(numpy_tree(jgrads)), flat_tree(tgrads)
    before = flat_tree(export_jax_params(tm))
    opt = make_optimizer(tm)
    assert set(opt.optimizers) == set(opt_names)
    grouped = {id(p) for o in opt.optimizers.values()
               for g in o.param_groups for p in g["params"]}
    for n, p in tm.named_parameters():
        assert (id(p) in grouped) == (n.split(".")[1] == net), n
    run_step(opt)
    after = flat_tree(export_jax_params(tm))
    moved = checked = 0
    for path, leaf in want.items():
        if path[:2] != ("netInstance", net):
            np.testing.assert_array_equal(leaf, init[path])
            np.testing.assert_array_equal(after[path], before[path])
            continue
        diff = np.abs(after[path] - leaf)
        assert diff.max() <= 2.1e-4, "/".join(path)
        g = grads[path]
        clear = np.abs(g) > max(1e-6, 10 * np.abs(tgrads[path] - g).max())
        assert (diff * clear).max() <= 2e-6, "/".join(path)
        if np.abs(g).max() > 1e-6:
            assert clear.mean() >= MIN_CLEAR_SHARE, "/".join(path)
            checked += 1
        moved += int(np.any(after[path] != before[path]))
    assert moved > 5 and checked > 5


def test_stage1_adam_step_matches_jax(pair, step):
    """Stage 1's `make_optimizer` holds one Adam (`instance`) on
    `netArticulation` alone (no `base` Adam: netBase is frozen, as the
    JAX trainer's empty `base` partition); one `train_step` moves it as
    optax moves JAX's, and nothing else."""
    pair.reset()

    def run(opt):
        train_step(pair.tm, opt, pair.tbatch, IT, None, pair.tphase,
                   noise=pair.noise(jax.random.PRNGKey(step["seed"])))
    _adam_step_matches(pair.jm, pair.jp, pair.tm, step["jgrads"],
                       step["tgrads"], run, "netArticulation", {"instance"})
    pair.reset()


def test_adam_counts_steps_without_gradient_as_optax():
    """A grouped parameter that no step reaches for a while (netArticulation
    in stage 1 before articulation starts at 10,000; netDeform before
    90,000) takes zero gradients, so its Adam step count runs with the
    others' as optax's does for a partition: after two steps without a
    gradient and one with, the parameter equals optax's within 1e-7: its
    first real update is 0.64 lr there (3.16 lr after thousands of empty
    steps), not the lr of a first torch Adam step."""
    from torch import nn
    from animals3d_tpu_torch.models.animal import OptimizerConfig
    from animals3d_tpu_torch.trainer import Optimizer

    class Model(nn.Module):
        cfg_optim_base = cfg_optim_instance = OptimizerConfig(lr=1e-2)

        def __init__(self):
            super().__init__()
            self.netBase = nn.Linear(3, 2)
            self.netInstance = nn.Linear(2, 2)

        def frozen_param(self, keys):
            return False
    m = Model()
    w0 = m.netInstance.weight.detach().numpy().copy()
    opt = Optimizer(m)
    g = np.random.default_rng(0).normal(size=w0.shape).astype(np.float32)
    for i in range(3):
        m.netBase.weight.grad = torch.ones_like(m.netBase.weight)
        if i == 2:
            m.netInstance.weight.grad = t(g)
        opt.step()
        opt.zero_grad()
    tx = optax.adam(1e-2)
    p, st = jnp.asarray(w0), tx.init(jnp.asarray(w0))
    for gi in (np.zeros_like(g), np.zeros_like(g), g):
        u, st = tx.update(jnp.asarray(gi), st, p)
        p = optax.apply_updates(p, u)
    close(m.netInstance.weight, p, rtol=0, atol=1e-7)
    assert np.abs(np.asarray(p) - w0).max() < 0.65e-2   # 0.64 lr, not lr


# ---------------------------------------------------------------------------
# stage 2: the VAE's training forward, and generation
# ---------------------------------------------------------------------------

def _stage2_batch():
    b = fake_batch_np(3, B=2, F=3)
    return b, batch_to(b, jnp.asarray), batch_to(b, torch.from_numpy)


def _stage2_noise(jm, jp, tm, rng, n_images, generate=False):
    """The JAX forward's draws for `rng`: the eikonal points (the prior's
    vertex count from the port's prior, exact between the packages), the
    VAE's ε, and with `generate` the frame pick and z."""
    K = tm.netInstance.num_pose_hypos
    D = tm.cfg_motion_vae.latent_dim
    phase = tm.phase_for_iter(IT, is_training=not generate)
    grid, v_cap, f_cap = tm.grid_for_phase(phase)
    first = jax_noise(rng, n_images, K)
    with torch.no_grad():
        prior, *_ = tm.forward_base(
            grid, v_cap, f_cap,
            jitter=None if generate else first.jitter_u)
    Bn = n_images // tm.num_frames
    return jax_noise(rng, n_images, K, int(prior.num_verts),
                     vae=(jm.netInstance, jp["netInstance"], (1, Bn, D)),
                     generate=(n_images, (1, 1, D)) if generate else None)


@pytest.fixture(scope="module")
def stage2_step(stage2):
    """Both packages' stage-2 forward and gradients at the first key whose
    articulation (the VAE's angles, which the feet move by ~0.1) agrees
    within 1e-4."""
    jm, jp, tm = stage2
    _b, jbatch, tbatch = _stage2_batch()
    phase = jm.phase_for_iter(IT)
    grid = jm.grid_for_phase(phase)[0]
    vg = jax.jit(jax.value_and_grad(
        lambda p, rng: jm.forward(p, jbatch, IT, rng, phase, grid),
        has_aux=True))
    for seed in range(16):
        rng = jax.random.PRNGKey(seed)
        (jloss, (jmet, jaux)), jgrads = vg(jp, rng)
        noise = _stage2_noise(jm, jp, tm, rng, 6)
        tm.zero_grad(set_to_none=True)
        tloss, (tmet, taux) = tm.forward(tbatch, IT, None,
                                         tm.phase_for_iter(IT), noise=noise)
        gap = np.abs(to_np(taux["arti_params"].detach())
                     - np.asarray(jaux["arti_params"])).max()
        if gap <= 1e-4:
            break
    else:
        pytest.fail("no key of 16 on which both packages pick the same feet")
    tloss.backward()
    from animals3d_tpu_torch.convert_jax import export_jax_grads
    tgrads = export_jax_grads(tm)
    tm.zero_grad(set_to_none=True)
    return dict(seed=seed, jloss=jloss, jmet=jmet, jaux=jaux, jgrads=jgrads,
                tloss=tloss.detach(), tmet=tmet, taux=taux, tgrads=tgrads,
                noise=noise, tbatch=tbatch)


def test_stage2_forward_and_gradients_match_jax(stage2, stage2_step):
    """Render off, the reconstruction losses off; `arti_recon_loss`,
    `kld_loss` and every other metric at rtol 1e-4, the VAE's mu and
    logvar at rtol 1e-5 (atol 1e-5), and each `netVAE` gradient leaf
    within `GRAD_TOL` of its norm (the only port parameters with
    gradients)."""
    s = stage2_step
    assert set(s["tmet"]) == set(s["jmet"])
    assert {"arti_recon_loss", "kld_loss"} <= set(s["tmet"])
    assert "rgb_loss" not in s["tmet"] and s["taux"]["mask_pred"] is None
    for name, want in s["jmet"].items():
        np.testing.assert_allclose(float(s["tmet"][name]), float(want),
                                   rtol=1e-4, err_msg=name)
    np.testing.assert_allclose(float(s["tloss"]), float(s["jloss"]),
                               rtol=1e-4)
    gaps = _trained_gaps(s["tgrads"], s["jgrads"], "netVAE")
    bad = {"/".join(p): g for p, g in gaps.items() if g > GRAD_TOL}
    assert not bad, bad


def test_stage2_adam_step_matches_jax(stage2, stage2_step):
    """Stage 2's `make_optimizer` holds one Adam on `netVAE` alone; one
    `train_step` moves it as optax moves JAX's, and nothing else."""
    jm, jp, tm = stage2
    state = {k: v.clone() for k, v in tm.state_dict().items()}
    s = stage2_step

    def run(opt):
        train_step(tm, opt, s["tbatch"], IT, None, tm.phase_for_iter(IT),
                   noise=s["noise"])
    try:
        _adam_step_matches(jm, jp, tm, s["jgrads"], s["tgrads"], run,
                           "netVAE", {"instance"})
    finally:
        tm.load_state_dict(state)


def test_generate_matches_jax(stage2):
    """Stage 2's eval forward is `generate`: one frame picked from the
    batch, its shape and pose, a sampled sequence of `num_frames`
    articulations skinned onto it and rendered from the default camera.
    The same pick, the generated angles at rtol 1e-5 (atol 1e-6), the
    posed vertices within 1e-5, and the mask at `assert_images_close`'s
    limits. JAX's rast is computed in the same compiled function as its
    forward, as `tests/test_torch_recon.py` does: rasterized by eager ops
    instead, the posed vertices round otherwise and a silhouette pair on
    a sub-pixel face (0.18 px² on key 5) moves by 0.07, outside any
    face it flips."""
    jm, jp, tm = stage2
    _b, jbatch, tbatch = _stage2_batch()
    phase = jm.phase_for_iter(IT, is_training=False)
    rng = jax.random.PRNGKey(5)
    grid = jm.grid_for_phase(phase)[0]
    Fr = tm.num_frames
    jmvp = jm.default_cameras(Fr)[0]   # its numpy cache, made untraced

    def chain(p, r):
        _l, (_m, aux) = jm.forward(p, jbatch, IT, r, phase, grid)
        shape = aux["shape"]
        return aux, jrz.rasterize(jxfm(shape.v_pos, jmvp), shape.t_pos_idx,
                                  shape.f_valid, (64, 64))
    jaux, jrast = jax.jit(chain)(jp, rng)
    noise = _stage2_noise(jm, jp, tm, rng, 6, generate=True)
    with torch.no_grad():
        _l, (_m, taux) = tm.forward(tbatch, IT, None,
                                    tm.phase_for_iter(IT, False),
                                    noise=noise)
    assert taux["shape"].v_pos.shape[0] == jaux["shape"].v_pos.shape[0] == Fr
    assert taux["arti_params"].shape[:2] == (1, Fr)
    assert taux["mask_pred"].shape == jaux["mask_pred"].shape == (1, Fr, 64,
                                                                  64)
    close(taux["arti_params"], jaux["arti_params"], atol=1e-6)
    close(taux["shape"].v_pos, jaux["shape"].v_pos, rtol=0, atol=1e-5)
    mvp = tm.default_cameras(Fr)[0]
    v_clip = txfm(taux["shape"].v_pos, mvp)
    faces, fv = taux["shape"].t_pos_idx, taux["shape"].f_valid
    rast = rc.rasterize_cuda(v_clip, faces, fv, (64, 64),
                             v_pos0=taux["shape"].v_pos[0])
    assert (to_np(rast.face_id) > 0).sum() > 100
    assert_images_close(to_np(taux["mask_pred"]).reshape(Fr, 1, 64, 64),
                        np.asarray(jaux["mask_pred"]).reshape(Fr, 1, 64, 64),
                        rast, jrast, v_clip, faces)


# ---------------------------------------------------------------------------
# the loop on a sequence tree
# ---------------------------------------------------------------------------

def test_stage1_trainer_test_path_writes_flow_artifacts(tmp_path):
    """The port's version of `tests/test_ponymation.py::
    test_stage1_trainer_test_path_writes_flow_artifacts`: stage 1's
    `Trainer.train` (one iteration) then `Trainer.test` on a synthetic
    sequence tree with flows loaded and rendered; the test files include
    per-frame `_flow_gt.png` and `_flow_pred.png`."""
    from animals3d_tpu_torch import config as tcfg
    from animals3d_tpu_torch.data.synth import write_synth_dataset
    from animals3d_tpu_torch.models import build_model
    from animals3d_tpu_torch.trainer import Trainer
    root = tmp_path / "seq_ds"
    write_synth_dataset(str(root), size=64, dino_dim=4, sequences=2,
                        frames=4)
    ckpt_dir = str(tmp_path / "ckpt")
    overrides = TINY_PONY + [
        f"dataset.train_data_dir={root}", f"dataset.test_data_dir={root}",
        f"checkpoint_dir={ckpt_dir}", "num_iters=1",
        "save_checkpoint_freq=1", "use_logger=false",
        "dataset.num_workers=1", "run_test=true", "checkpoint_path=null",
        "dataset.val_data_dir=null", "dataset.load_flow=true",
        "model.cfg_render.render_flow=true"]
    cfg = tcfg.load_config(STAGE1, overrides=overrides)
    model_cfg = dict(cfg["model"])
    model_cfg["dataset"] = cfg["dataset"]
    model = build_model(model_cfg, device="cpu")
    trainer = Trainer(cfg, model)
    try:
        trainer.train()
        trainer.test()
    finally:
        set_mixed_precision(None)
    out = os.path.join(ckpt_dir, "test_results_0000001")
    files = os.listdir(out)
    assert any(f.endswith("_image_pred.png") for f in files)
    assert any(f.endswith("_flow_gt.png") for f in files), files[:8]
    assert any(f.endswith("_flow_pred.png") for f in files), files[:8]
