"""The port's 3D-Fauna against the JAX package, on the CPU in float32.

Models: `train_fauna` at `tests/test_fauna.py`'s `TINY_FAUNA` widths (64²,
grid 8, bank 14 with top 3), the flax init tree carried over with
`convert_jax`; one pair serves the file.

  * the modules at rtol 1e-5: `LinearMod`, `MLPMod` and `CoordMLPMod`
    (values and input gradients), `DCDiscriminator`, `bce_loss_target` and
    `r1_penalty` (its value and its gradient with respect to the
    discriminator's weights), `retrieve_memory_bank`, the class token,
    Fauna's articulation constraints, `parse_dict_definition` and
    `phase_for_iter`;
  * the training forward at iteration 100,000 (inside the discriminator
    window, articulation on, legs attached, deformation off) with JAX's
    draws imposed, the random view's azimuth included: loss and metrics
    at rtol 1e-4 (`mask_disc_loss` among them) and every gradient leaf
    within `tests/test_torch_train.py`'s `GRAD_TOL` of its norm (its
    `NOISY_LEAVES` within `NOISY_TOL`), the bank and its keys among them;
  * the discriminator step on the recorded masks: `discriminator_loss` and
    its gradient tree, then one step of the port's `disc` Adam against
    `optax.adam`.

The key is picked at run time as in `tests/test_torch_train.py`
(`search_here`: feet, faces, antialias blend branches, texture ReLU ties,
in a child process), with the face and blend-branch checks extended to
the random view and each package's own steadiness under one-ulp nudges
(`FaunaPair.other_views_agree`, `FaunaPair.jax_steady`), on one image
with a full-frame target mask (`FaunaPair`). At 8 torch threads the
search takes key 25: of keys 0 to 24 all but 6 flip a face or a blend
branch in the input or the random view, and key 6 is one ulp from a
decision (a nudge moves JAX's own tree by more than a tolerance).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from animals3d_tpu.models import fauna as jfauna
from animals3d_tpu.networks import discriminator as jdisc
from animals3d_tpu.networks import mlp as jmlp
from animals3d_tpu_torch.convert_jax import (export_jax_grads,
                                             export_jax_params,
                                             load_jax_params)
from animals3d_tpu_torch.models import fauna as tfauna
from animals3d_tpu_torch.networks import discriminator as tdisc
from animals3d_tpu_torch.networks import mlp as tmlp
from animals3d_tpu_torch.ops.antialias import silhouette_pairs
from animals3d_tpu_torch.ops.rasterize_cuda import rasterize_cuda
from animals3d_tpu_torch.precision import set_mixed_precision
from animals3d_tpu_torch.render.camera import xfm_points
from animals3d_tpu_torch.trainer import disc_step, make_optimizer, train_step
from test_fauna import TINY_FAUNA
from test_torch_train import (GRAD_TOL, Pair, blend_branches, gradient_gaps,
                              leaf_tolerance, search_steps, worst_multiple)
from torch_parity import (_silhouette_pairs, batch_to, build_pair,
                          flat_tree, numpy_tree)

IT = 100000
# one image: each image (and its random view) must pass the key search's
# face and blend-branch checks, and about one key in twenty does at one
# image and two views; at two images none of the first 150 keys does
BATCH = 1
NUDGES = (1, 2, 3)   # the seeds of `FaunaPair.jax_steady`'s one-ulp nudges
RTOL = 1e-5          # the modules
PIXEL_ATOL = 1e-3    # `forward_agrees`' limit, for the random view's mask


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, rtol=RTOL, atol=1e-6):
    np.testing.assert_allclose(
        got.detach().numpy() if isinstance(got, torch.Tensor) else got,
        np.asarray(want), rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# the modules
# ---------------------------------------------------------------------------

def _mod_pair(name):
    """(flax module, its params, port module with them, inputs as numpy)
    of one of the three modulated layers."""
    r = np.random.default_rng(0)
    if name == "LinearMod":
        jm, tm = jmlp.LinearMod(7), tmlp.LinearMod(5, 7)
        x = r.normal(size=(2, 11, 5)).astype(np.float32)
        style = r.normal(size=(3, 5)).astype(np.float32)
    elif name == "MLPMod":
        jm, tm = jmlp.MLPMod(3, 3, 16), tmlp.MLPMod(16, 3, 3, 16)
        x = r.normal(size=(2, 11, 16)).astype(np.float32)
        style = r.normal(size=(1, 16)).astype(np.float32)
    else:
        jm = jmlp.CoordMLPMod(3, 1, 3, nf=16, n_harmonic_functions=4,
                              embedder_scalar=0.8, condition_dim=8)
        tm = tmlp.CoordMLPMod(3, 1, 3, nf=16, n_harmonic_functions=4,
                              embedder_scalar=0.8, condition_dim=8)
        x = r.normal(size=(1, 50, 3)).astype(np.float32)
        style = r.normal(size=(1, 8)).astype(np.float32)
    params = jm.init(jax.random.PRNGKey(1), x, style)["params"]
    load_jax_params(tm, numpy_tree(params))
    return jm, params, tm, x, style


@pytest.mark.parametrize("name", ["LinearMod", "MLPMod", "CoordMLPMod"])
def test_modulated_layers_match_jax(name):
    """Value and the gradient of sum(out²) with respect to the input and
    the style or condition (only the first style row modulates: the other
    rows get none), rtol 1e-5. The demodulation sums the weight's input
    axis: flax keeps the weight (in, out), the port (out, in)."""
    set_mixed_precision(None)
    jm, params, tm, x, style = _mod_pair(name)

    def f(x_, s_):
        return jnp.sum(jm.apply({"params": params}, x_, s_) ** 2)
    want = jm.apply({"params": params}, x, style)
    jgx, jgs = jax.grad(f, argnums=(0, 1))(x, style)
    tx, ts = t(x).requires_grad_(True), t(style).requires_grad_(True)
    out = tm(tx, ts)
    (out ** 2).sum().backward()
    close(out, want)
    close(tx.grad, jgx)
    close(ts.grad, jgs)
    if name == "LinearMod":
        assert not ts.grad[1:].any()


def test_discriminator_bce_and_r1_match_jax():
    """`DCDiscriminator` on a 32² input (3 stride-2 convolutions and the
    VALID output convolution), `bce_loss_target` against 0 and 1, and the
    R1 penalty's value and its gradient with respect to the weights (a
    gradient of the input gradient), rtol 1e-5."""
    set_mixed_precision(None)
    r = np.random.default_rng(0)
    x = r.uniform(0, 1, (3, 5, 32, 32)).astype(np.float32)
    jd = jdisc.DCDiscriminator(in_dim=5, n_feat=16, img_size=32)
    params = jd.init(jax.random.PRNGKey(2), x)["params"]
    td = tdisc.DCDiscriminator(in_dim=5, n_feat=16, img_size=32)
    load_jax_params(td, numpy_tree(params))
    D = lambda p: lambda v: jd.apply({"params": p}, v)
    want = D(params)(x)
    got = td(t(x))
    close(got, want)
    for target in (0.0, 1.0):
        close(tdisc.bce_loss_target(got, target),
              jdisc.bce_loss_target(want, target))
    jr1, jg = jax.value_and_grad(
        lambda p: jdisc.r1_penalty(D(p), x))(params)
    tr1 = tdisc.r1_penalty(td, t(x))
    tr1.backward()
    close(tr1, jr1)
    jg, tg = flat_tree(numpy_tree(jg)), flat_tree(export_jax_grads(td))
    assert set(jg) == set(tg) and len(tg) == 4
    for path, leaf in jg.items():
        assert np.abs(leaf).max() > 0
        close(tg[path], leaf, atol=1e-7)


@pytest.fixture(scope="module")
def models():
    """(JAX Fauna, its init params, port Fauna with the same weights)."""
    set_mixed_precision(None)
    return build_pair(TINY_FAUNA, "train_fauna", (0, IT))


def _tokens(n, seed):
    return np.random.default_rng(seed).normal(size=(n, 384)) \
        .astype(np.float32)


def test_retrieve_memory_bank_matches_jax(models):
    """Indices equal, weights and per-image and batch-mean embeddings at
    rtol 1e-5, on the init bank (its 14 rows are two copies of a 7-row
    block, but the keys differ) and on a bank whose keys repeat, so that
    similarities tie exactly: `jax.lax.top_k` then takes the lower index
    first, and so does the port's stable descending sort; the indices are
    equal in order, not only as a set."""
    jm, jp, tm = models
    for keys in (None, "tied"):
        p = jp["netBase"]
        if keys == "tied":
            k = np.asarray(p["memory_bank_keys"])
            p = {**p, "memory_bank_keys": jnp.asarray(
                np.concatenate([k[:7], k[:7]]))}
        with torch.no_grad():
            tm.netBase.memory_bank_keys.copy_(t(p["memory_bank_keys"]))
        q = _tokens(5, 3)
        jmean, jemb, jaux = jm.netBase.apply(
            {"params": p}, q, method="retrieve_memory_bank")
        with torch.no_grad():
            tmean, temb, taux = tm.netBase.retrieve_memory_bank(t(q))
        np.testing.assert_array_equal(taux["pick_idx"].numpy(),
                                      np.asarray(jaux["pick_idx"]))
        close(taux["weights"], jaux["weights"])
        close(temb, jemb)
        close(tmean, jmean)
        if keys == "tied":
            idx = taux["pick_idx"].numpy()
            # both copies of a key tie; the lower index comes first
            assert (np.abs(idx[:, 0] - idx[:, 1]) == 7).all()
    with torch.no_grad():
        tm.netBase.memory_bank_keys.copy_(
            t(jp["netBase"]["memory_bank_keys"]))


def test_class_token_matches_jax(models):
    """The frozen ViT's final-norm class token on images × 2 − 1, without
    gradient, rtol 1e-5."""
    jm, jp, tm = models
    images = np.random.default_rng(4).uniform(
        0, 1, (2, 1, 3, 64, 64)).astype(np.float32)
    want = jm.netInstance.apply({"params": jp["netInstance"]}, images,
                                method="frozen_vit_class_token")
    got = tm.netInstance.frozen_vit_class_token(t(images))
    assert not got.requires_grad and got.shape == (2, 384)
    close(got, want, atol=1e-5)


@pytest.mark.parametrize("it", [100000, 300000, 300001, 400000])
def test_articulation_constraints_match_jax(models, it):
    """Fauna's constraint chain on random angles at iterations on either
    side of `iter_leg_rotation_start` (300,000: the leg clamp until it,
    the leg-rotation rules after it), rtol 1e-5."""
    jm, jp, tm = models
    phase = jm.phase_for_iter(it)
    assert tuple(phase) == tuple(tm.phase_for_iter(it))
    assert phase.leg_rot_started == (it > 300000)
    K = tm.netInstance.num_bones
    angles = np.random.default_rng(it).normal(
        size=(2, 1, K, 3)).astype(np.float32) * 5
    want = jm.netInstance.apply(
        {"params": jp["netInstance"]}, jnp.asarray(angles), phase,
        method="apply_articulation_constraints")
    got = tm.netInstance.apply_articulation_constraints(t(angles), phase)
    close(got, want, atol=1e-7)


SCHEDULE_EDGES = [0, 1, 19999, 20000, 20001, 59999, 60000, 79999, 80000,
                  80001, 100000, 299999, 300000, 300001, 499999, 500000,
                  800000]


@pytest.mark.parametrize("it", SCHEDULE_EDGES)
def test_schedule_matches_jax(models, it):
    """`phase_for_iter` (training and eval), the scheduled loss and logit
    weights (`parse_dict_definition` of the config's dicts, keys and
    order as loaded) at the schedule's edges."""
    jm, jp, tm = models
    for training in (True, False):
        assert tuple(jm.phase_for_iter(it, training)) == \
            tuple(tm.phase_for_iter(it, training))
    cl = tm.cfg_loss
    assert list(cl.dino_feat_im_loss_weight_dict) == [0, 300000]
    assert list(cl.logit_loss_dino_feat_im_loss_multiplier_dict) == \
        [0, 300000]
    for d in (cl.dino_feat_im_loss_weight_dict,
              cl.logit_loss_dino_feat_im_loss_multiplier_dict):
        assert tfauna.parse_dict_definition(d, it) == float(
            jfauna.parse_dict_definition(d, jnp.asarray(float(it))))
    for name in ("dino_feat_im_loss", "mask_loss", "mask_inv_dt_loss",
                 "rgb_loss", "mask_disc_loss"):
        np.testing.assert_allclose(tm.logit_weight(name, it),
                                   float(jm.logit_weight(name, it)),
                                   rtol=1e-7)
        np.testing.assert_allclose(tm.loss_weight(name, it),
                                   float(jm.loss_weight(name, it)),
                                   rtol=1e-7)


# ---------------------------------------------------------------------------
# the training forward
# ---------------------------------------------------------------------------

class FaunaPair(Pair):
    """`tests/test_torch_train.py`'s `Pair` on the Fauna models, at `IT`,
    on a batch of `BATCH` image whose target mask covers the whole frame;
    its key search also holds the random view (`other_views_agree`).

    The full-frame target is to the mask terms what the dark targets are
    to the rgb and feature terms: Fauna weighs the mask 100 and the
    inverse distance transform 1,000 (MagicPony 10 and 100), and against
    `fake_batch_np`'s square the mask residuals change sign across its
    edge, so the articulation, encoder and bank-key leaves are the small
    remainder of large silhouette terms of both signs; a one-ulp nudge of
    JAX's own parameters then moves them by up to 1.28 tolerances (key 6
    of the square's search). Against a full frame every mask residual and
    every inverse-distance term has one sign, and the same leaves read at
    most 0.37 tolerances from JAX on the keys whose decisions agree."""

    def __init__(self, it=IT, overrides=TINY_FAUNA, models=None):
        models = models or build_pair(overrides, "train_fauna", (0, it))
        super().__init__(it, overrides, models=models, batch_size=BATCH)
        self.batch["masks"][:] = 1.0
        self.jbatch = batch_to(self.batch, jnp.asarray)
        self.tbatch = batch_to(self.batch, torch.from_numpy)

    def rv_clip(self, aux, noise):
        """The posed vertices of `aux` in clip space of the random view
        that `noise` draws, on the cameras of `aux`'s w2c."""
        w2c = aux["w2c"]
        w2c = w2c if isinstance(w2c, torch.Tensor) else t(w2c)
        v_pos = aux["shape"].v_pos
        v_pos = v_pos if isinstance(v_pos, torch.Tensor) else t(v_pos)
        mvp, _w, _c = self.tm.random_view_cameras(w2c.detach(),
                                                  v_pos.shape[0], None, noise)
        return xfm_points(v_pos.detach(), mvp)

    def other_views_agree(self, rng, jout, tout):
        """The random view's decisions: its mask within `PIXEL_ATOL` on
        every pixel; the same face at every pixel of a silhouette pair when
        both packages' posed vertices are rasterized from it (the mask is
        untextured, so such a flip does not show in it, but it moves the
        antialias pass's gradient to other vertices); and the same
        antialias blend branches."""
        (jmet, jaux), (tmet, taux) = jout, tout
        got = tmet["_disc_record"]["mask_rv"][:, 0].detach().numpy()
        want = np.asarray(jmet["_disc_record"]["mask_rv"])[:, 0]
        if np.abs(got - want).max() > PIXEL_ATOL:
            return False
        noise = self.noise(rng)
        tv, jv = self.rv_clip(taux, noise), self.rv_clip(jaux, noise)
        shape = taux["shape"]
        faces, res = shape.t_pos_idx, tuple(got.shape[-2:])
        v0 = shape.v_pos[0].detach()
        with torch.no_grad():
            rast = rasterize_cuda(tv, faces, shape.f_valid, res, v_pos0=v0)
            jrast = rasterize_cuda(jv, faces, shape.f_valid, res, v_pos0=v0)
            # the pixels the antialias pass reads: both of each silhouette
            # pair (a face that flips elsewhere is an interior edge tie)
            sil = _silhouette_pairs(rast.face_id.numpy(), rast.z.numpy()) \
                | _silhouette_pairs(jrast.face_id.numpy(), jrast.z.numpy())
            if (rast.face_id.numpy() != jrast.face_id.numpy())[sil].any():
                return False
            if not bool((blend_branches(silhouette_pairs(
                    rast, tv, faces)) == blend_branches(
                    silhouette_pairs(rast, jv, faces))).all()):
                return False
        return self.jax_steady(rng)

    def jax_steady(self, rng):
        """Each package's own gradient tree stays within each leaf's
        tolerance of itself when its parameters are nudged by one float32
        ulp (random signs, `NUDGES`). Fauna weighs the silhouettes 10
        times as much as MagicPony (mask 100, inverse distance transform
        1,000), so its articulation, encoder and bank-key leaves are sums
        of large terms of both signs, and on some keys a one-ulp nudge
        already moves them by a tolerance: a key one ulp from a decision
        (`ROADMAP.md` C), where neither package holds itself to the
        tolerance. This compares each package with itself, never with the
        other. The port's nudges go to a copy of its model: the search's
        own forward still holds the graph of the original."""
        tm = self.tm
        self.tm = copy.deepcopy(tm)
        try:
            for grads_aux in (self.jax_grads_aux, self.port_grads_aux):
                grads, _ = grads_aux(rng)
                for nudge in NUDGES:
                    moved, _ = grads_aux(rng, nudge=nudge)
                    if worst_multiple({
                            p: np.linalg.norm(moved[p] - g)
                            / np.linalg.norm(g) for p, g in grads.items()
                            if "ViT" not in p
                            and np.linalg.norm(g) > 0}) > 1:
                        return False
            return True
        finally:
            self.tm = tm


def child_search(its, overrides):
    """`search_here` on a `FaunaPair` at each iteration (the child of
    `torch_search` calls this)."""
    from test_torch_train import search_here
    out, first = {}, None
    for it in its:
        pair = FaunaPair(it, overrides, models=first and (
            first.jm, first.jp, first.tm))
        first = first or pair
        try:
            out[it] = (search_here(pair), pair.tie_keys, pair.relu_keys)
        except pytest.fail.Exception as e:
            out[it] = f"iteration {it}: {e}"
    return out


@pytest.fixture(scope="module")
def pair(models):
    return FaunaPair(models=models)


@pytest.fixture(scope="module")
def step(pair):
    """The key search at `IT`, in a child process (`search_steps`)."""
    s = search_steps({IT: pair}, "test_torch_fauna")[IT]
    if isinstance(s, str):
        pytest.fail(s)
    print(f"iteration {IT}: key {s['seed']}")
    return s


def test_forward_loss_and_metrics_match_jax(pair, step):
    """The phase (disc window, articulation on, legs attached, deformation
    off, no zero-y), the discrete decisions (pose hypothesis, random-pose
    flag, articulation within 1e-4), every metric and the total at rtol
    1e-4, `mask_disc_loss` among them, and the recorded masks: the
    ground truth's and the random view's within 1e-3, the class vector's
    channels at rtol 1e-5."""
    ph = pair.phase
    assert ph.disc_on and ph.articulation_on and ph.attach_legs \
        and not ph.deform_on and not ph.zeroy and ph.constrain_legs
    jaux, taux = step["jaux"], step["taux"]
    np.testing.assert_array_equal(np.asarray(jaux["rot_idx"]),
                                  taux["rot_idx"].numpy())
    np.testing.assert_array_equal(np.asarray(jaux["rand_pose_flag"]),
                                  taux["rand_pose_flag"].numpy())
    close(taux["arti_params"], jaux["arti_params"], rtol=0, atol=1e-4)
    jmet = {k: v for k, v in step["jmet"].items() if k != "_disc_record"}
    tmet = {k: v for k, v in step["tmet"].items() if k != "_disc_record"}
    assert set(tmet) == set(jmet) and "mask_disc_loss" in tmet
    for name, want in jmet.items():
        np.testing.assert_allclose(float(tmet[name]), float(want),
                                   rtol=1e-4, err_msg=name)
    np.testing.assert_allclose(float(step["tloss"]), float(step["jloss"]),
                               rtol=1e-4)
    jrec, trec = step["jmet"]["_disc_record"], step["tmet"]["_disc_record"]
    for k in ("mask_gt", "mask_iv", "mask_rv"):
        close(trec[k][:, :1], np.asarray(jrec[k])[:, :1], rtol=0,
              atol=PIXEL_ATOL)
        close(trec[k][:, 1:], np.asarray(jrec[k])[:, 1:])
    close(taux["class_vector"], jaux["class_vector"])
    assert float(trec["mask_rv"][:, 0].sum()) > 0


def test_gradient_tree_matches_jax(step):
    """Every leaf within its tolerance of the norm (`GRAD_TOL`, and
    `NOISY_TOL` on the texture and DINO fields' first layers), the memory
    bank, its keys, the modulated SDF's layers and `netDisc` among them
    (the generator's loss reaches the discriminator's weights in both
    packages; neither generator optimizer steps them)."""
    gaps = gradient_gaps(flat_tree(step["tgrads"]),
                         flat_tree(numpy_tree(step["jgrads"])))
    for leaf in (("netBase", "memory_bank"), ("netBase", "memory_bank_keys"),
                 ("netBase", "netSDF", "mlp", "linear_0", "weight"),
                 ("netBase", "netSDF", "style_mlp", "layer_0", "kernel"),
                 ("netDisc", "conv_0", "kernel")):
        assert leaf in gaps, leaf
    bad = {"/".join(p): g for p, g in gaps.items() if g > leaf_tolerance(p)}
    assert not bad, bad
    assert max(gaps.values()) <= 5 * GRAD_TOL


def test_generator_step_leaves_the_discriminator(pair, step):
    """A `train_step` with `make_optimizer` moves netBase and netInstance
    but not `netDisc`: the generator's Adams hold no discriminator
    parameter, and the `disc` Adam is left alone."""
    pair.reset()
    opt = make_optimizer(pair.tm)
    assert set(opt.optimizers) == {"base", "instance"} and opt.disc
    grouped = {id(p) for o in opt.optimizers.values()
               for g in o.param_groups for p in g["params"]}
    assert not grouped & {id(p) for p in pair.tm.netDisc.parameters()}
    before = flat_tree(export_jax_params(pair.tm))
    met = train_step(pair.tm, opt, pair.tbatch, IT, None, pair.tphase,
                     noise=pair.noise(jax.random.PRNGKey(step["seed"])))
    after = flat_tree(export_jax_params(pair.tm))
    assert "_disc_record" in met and not opt.disc.state
    moved = {p for p, leaf in before.items()
             if not np.array_equal(after[p], leaf)}
    assert not {p for p in moved if p[0] == "netDisc" or "ViT" in p}
    assert {("netBase", "memory_bank"), ("netBase", "memory_bank_keys")} \
        <= moved and len(moved) > 40
    pair.reset()


def test_discriminator_step_matches_jax(pair, step):
    """On JAX's recorded masks: `discriminator_loss` (random view fake,
    input view real with 10 × its R1 penalty) at rtol 1e-4, its gradient
    tree within `GRAD_TOL` of each leaf's norm; then one step of the
    port's `disc` Adam (`trainer.disc_step`) against `optax.adam` at the
    config's lr from the same weights: entries within 2e-6 of JAX's, 2%
    of an update, except where the gradient is of the order of eps."""
    pair.reset()
    jrec = {k: jnp.asarray(v) for k, v in
            step["jmet"]["_disc_record"].items()}
    dp = pair.jp["netDisc"]
    jloss, jg = jax.value_and_grad(pair.jm.discriminator_loss)(dp, jrec)
    trec = {k: t(v) for k, v in jrec.items()}
    pair.tm.netDisc.zero_grad(set_to_none=True)
    tloss = pair.tm.discriminator_loss(trec)
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-4)
    tg = flat_tree(export_jax_grads(pair.tm.netDisc))
    jgf = flat_tree(numpy_tree(jg))
    assert set(tg) == set(jgf)
    for path, leaf in jgf.items():
        gap = np.linalg.norm(tg[path] - leaf) / np.linalg.norm(leaf)
        assert gap <= GRAD_TOL, (path, gap)
    pair.reset()
    opt = make_optimizer(pair.tm)
    loss = disc_step(pair.tm, opt, trec)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    lr = pair.tm.cfg_optim_discriminator.lr
    assert opt.disc.param_groups[0]["lr"] == lr == \
        pair.jm.cfg_optim_discriminator.lr
    tx = optax.adam(lr)
    updates, _ = tx.update(jg, tx.init(dp), dp)
    want = flat_tree(numpy_tree(optax.apply_updates(dp, updates)))
    got = flat_tree(export_jax_params(pair.tm.netDisc))
    for path, leaf in want.items():
        diff = np.abs(got[path] - leaf)
        assert diff.max() <= 2.1 * lr, path
        assert (diff > 2e-6).sum() <= max(1, 0.01 * diff.size), path
    assert all(p.grad is None for p in pair.tm.netDisc.parameters())
    pair.reset()
