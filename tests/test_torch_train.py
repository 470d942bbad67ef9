"""The port's training step against the JAX package, on the CPU in
float32 (no TF32 on the CPU): `AnimalModel.forward` at the iter-50000
training phase (coarse grid, articulation on, grid jitter and random pose
sampling on, the fused netSDF sweep on both sides), its whole gradient
tree, one Adam step of `make_optimizer`, and a short loss trajectory.

Both sides get the same weights (`load_jax_params`), batch and random
numbers: `torch_parity.jax_noise` reproduces the draws of the JAX forward
from its key and hands them to the port as a `Noise`.

The batch is `fake_batch_np` with its images and feature targets scaled
by 0.1. With uniform-noise targets the residuals of the rgb (L1) and
feature (L2) losses have random signs, so a leaf's gradient is the small
remainder of thousands of per-pixel terms that cancel, and one ReLU unit
of the texture or DINO field that switches at one pixel — their inputs are
harmonic embeddings of up to 2^9 cycles of a per-pixel position — moves
the leaf by up to 1.2e-2 of its norm. Dark targets keep the residuals of
one sign, the sums add up, and the same event moves a leaf by ~1e-3.
`tests/torch_grad_noise.py` prints, leaf by leaf, the gap between the
two packages beside each package's own movement when its parameters are
nudged by one float32 ulp: the two are of one size (see the gradient
test's docstring for the readings).

The random keys are picked at run time from 0, 1, 2, ... as the first on
which the two packages agree on every discrete decision (`agree`): which
vertex is each leg's foot, and which face wins each pixel. `estimate_bones`
takes a foot as the lowest vertex of a quadrant, and marching-tets vertices
on horizontal lattice edges share their height up to float32 rounding, so
under grid jitter about one key in four lets the two packages pick
different feet (articulation then differs by ~0.1); most keys flip a face
on one of the ~400 silhouette pixels. About one key in fifteen passes
(keys 22, 33 and 59 of the first 60 at 1 and at 8 CPU threads). Which keys
those are depends on the last bit of float32 sums, hence on the CPU thread
count, so no key is hard-coded. The selection looks only at those
decisions, never at the quantities the tests compare.
"""
import contextlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from animals3d_tpu.geometry import skinning as jskinning
from animals3d_tpu.trainer import make_optimizer as jmake_optimizer
from animals3d_tpu_torch.convert_jax import (export_jax_grads,
                                             export_jax_params)
from animals3d_tpu_torch.geometry import skinning as tskinning
from animals3d_tpu_torch.ops import fused_mlp, resolve_cuda
from animals3d_tpu_torch.precision import set_mixed_precision
from animals3d_tpu_torch.trainer import make_optimizer, train_step
from torch_parity import (TRAIN_OVERRIDES, batch_to, build_pair,
                          fake_batch_np, flat_tree, jax_noise, numpy_tree)

IT = 50000
TRAJECTORY_RTOL = (1e-4, 1e-3, 5e-2, 5e-2)   # per step; see the test
MAX_KEYS = 150      # keys tried before giving up (about 1 in 15 agrees)
DARK = 0.1          # scale of the image and feature targets (see above)
GRAD_TOL = 1e-3     # |Δ| / ‖leaf‖ of a gradient leaf against the JAX tree
# the first two layers of the two fields that are sampled per pixel through
# a harmonic embedding: one ReLU unit that switches at one pixel shows here
NOISY_LEAVES = (("netBase", "netDINO", "in_layer"),
                ("netBase", "netDINO", "mlp", "layer_0"),
                ("netInstance", "netTexture", "in_layer"),
                ("netInstance", "netTexture", "mlp", "layer_0"))
NOISY_TOL = 5e-3


def agree(jaux, taux, arti_atol=1e-4, pixel_atol=1e-3):
    """The discrete decisions of one forward agree: feet (articulation
    within `arti_atol`; another foot moves it by ~0.1) and winning faces
    (rendered mask, image and features within `pixel_atol` on every pixel;
    a flipped face moves them by ~0.1)."""
    def gap(k):
        return np.abs(np.asarray(jaux[k])
                      - taux[k].detach().numpy()).max()
    return gap("arti_params") <= arti_atol and all(
        gap(k) <= pixel_atol for k in ("mask_pred", "image_pred",
                                       "dino_pred"))


def same_feet(pair, jaux, taux):
    """Both packages put the rest bones on the same vertices: their own
    `estimate_bones` on their own prior mesh, endpoints within 1e-2
    (another foot vertex is a lattice edge or more away)."""
    a = pair.tm.netInstance.cfg.cfg_articulation
    kw = dict(n_body_bones=a.num_body_bones, n_legs=a.num_legs,
              n_leg_bones=a.num_leg_bones, body_bones_mode=a.body_bones_mode,
              attach_legs_to_body=pair.tphase.attach_legs,
              bone_y_threshold=a.bone_y_threshold,
              legs_to_body_joint_indices=a.legs_to_body_joint_indices)
    jmesh, tmesh = jaux["prior_mesh"], taux["prior_mesh"]
    jbones, _ = jskinning.estimate_bones(jmesh.v_pos[None], jmesh.v_valid,
                                         **kw)
    tbones, _ = tskinning.estimate_bones(tmesh.v_pos.detach()[None],
                                         tmesh.v_valid, **kw)
    return np.abs(np.asarray(jbones) - tbones.numpy()).max() <= 1e-2


class Pair:
    def __init__(self):
        set_mixed_precision(None)
        self.jm, self.jp, self.tm = build_pair(TRAIN_OVERRIDES)
        self.init_state = {k: v.clone() for k, v in
                           self.tm.state_dict().items()}
        self.phase = self.jm.phase_for_iter(IT)
        self.tphase = self.tm.phase_for_iter(IT)
        self.batch = fake_batch_np(0)
        for k in ("images", "dino_features"):
            self.batch[k] = (self.batch[k] * DARK).astype(np.float32)
        self.jbatch = batch_to(self.batch, jnp.asarray)
        self.tbatch = batch_to(self.batch, torch.from_numpy)
        grid, _, _ = self.jm.grid_for_phase(self.phase)
        self.value_and_grad = jax.jit(jax.value_and_grad(
            lambda p, rng: self.jm.forward(p, self.jbatch, IT, rng,
                                           self.phase, grid), has_aux=True))

    def reset(self):
        self.tm.load_state_dict(self.init_state)
        self.tm.zero_grad(set_to_none=True)

    def noise(self, rng):
        """The JAX forward's draws for `rng`; the surface indices need the
        jittered prior's vertex count, which is exact between the two
        packages (`tests/test_torch_prior.py`)."""
        K = self.tm.netInstance.num_pose_hypos
        first = jax_noise(rng, 2, K)
        grid, v_cap, f_cap = self.tm.grid_for_phase(self.tphase)
        with torch.no_grad():
            prior, _ = self.tm.forward_base(grid, v_cap, f_cap,
                                            jitter=first.jitter_u)
        return jax_noise(rng, 2, K, int(prior.num_verts))


@pytest.fixture(scope="module")
def pair():
    return Pair()


@pytest.fixture(scope="module")
def step(pair):
    """One forward and backward of both packages, at the first key on
    which their discrete decisions agree."""
    pair.reset()
    for seed in range(MAX_KEYS):
        rng = jax.random.PRNGKey(seed)
        (jloss, (jmet, jaux)), jgrads = pair.value_and_grad(pair.jp, rng)
        tloss, (tmet, taux) = pair.tm.forward(
            pair.tbatch, IT, None, pair.tphase, noise=pair.noise(rng))
        if agree(jaux, taux):
            break
    else:
        pytest.fail(f"no key of {MAX_KEYS} without a foot tie or a face flip")
    tloss.backward()
    grads = export_jax_grads(pair.tm)
    none = [n for n, p in pair.tm.named_parameters() if p.grad is None]
    pair.tm.zero_grad(set_to_none=True)
    return dict(seed=seed, jloss=jloss, jmet=jmet, jaux=jaux, jgrads=jgrads,
                tloss=tloss.detach(), tmet=tmet, taux=taux, tgrads=grads,
                no_grad=none)


def test_forward_loss_and_metrics_match_jax(pair, step):
    """Every metric and the total: rtol 1e-4. The discrete decisions agree
    first: pose hypothesis, random-pose flag, articulation (feet)."""
    assert pair.phase.is_training and pair.phase.articulation_on \
        and pair.phase.use_coarse_grid and not pair.phase.deform_on
    jaux, taux = step["jaux"], step["taux"]
    np.testing.assert_array_equal(np.asarray(jaux["rot_idx"]),
                                  taux["rot_idx"].numpy())
    np.testing.assert_array_equal(np.asarray(jaux["rand_pose_flag"]),
                                  taux["rand_pose_flag"].numpy())
    np.testing.assert_allclose(taux["arti_params"].detach().numpy(),
                               np.asarray(jaux["arti_params"]), atol=1e-4)
    assert set(step["tmet"]) == set(step["jmet"])
    for name, want in step["jmet"].items():
        got = float(step["tmet"][name].detach())
        np.testing.assert_allclose(got, float(want),
                                   rtol=1e-4, err_msg=name)
    np.testing.assert_allclose(float(step["tloss"]), float(step["jloss"]),
                               rtol=1e-4)
    assert float(step["tmet"]["rgb_loss"].detach()) > 0
    assert float(step["tmet"]["sdf_gradient_reg_loss"].detach()) > 0


def leaf_tolerance(path):
    noisy = any(path[:len(p)] == p for p in NOISY_LEAVES)
    return NOISY_TOL if noisy else GRAD_TOL


def gradient_gaps(got, want):
    """{path: |got − want| / ‖want‖} over the leaves of the JAX gradient
    tree `want` that the phase trains. The frozen ViT has zero gradients in
    the JAX tree and none in the port; a leaf the phase does not use
    (netDeform) is zero there and absent here."""
    gaps = {}
    for path, leaf in want.items():
        if "ViT" in path or path not in got:
            assert path not in got and not np.any(leaf), "/".join(path)
            continue
        assert np.isfinite(got[path]).all(), "/".join(path)
        norm = np.linalg.norm(leaf)
        assert norm > 0, "/".join(path)
        gaps[path] = np.linalg.norm(got[path] - leaf) / norm
    return gaps


def test_gradient_tree_matches_jax(step):
    """Every leaf's gradient, as |Δ| over the leaf's norm: 1e-3, and 5e-3
    on the four `NOISY_LEAVES`.

    Readings at 1, 2, 4 and 8 CPU threads, over the first three keys that
    pass `agree` at each (22; 31 to 33; 59 to 64): at worst 5.9e-4 outside
    the noisy leaves (articulation and encoder leaves, which see the
    silhouette through the antialias weights), 4.4e-4 on key 22; 1.7e-3
    on netDINO's in-layer and 2.6e-3 on
    netTexture's. That these gaps are float32 rounding and not the port:
    `tests/torch_grad_noise.py` nudges every parameter of one package by
    one float32 ulp and reads how far that package's own gradient moves.
    On key 22 the JAX tree moves by 1.7e-3 on netDINO's in-layer (gap to
    the port 1.5e-3), by 1.0e-3 on netTexture's (gap 4.8e-4) and by 6e-4
    to 9e-4 on the articulation and encoder leaves (gap 3e-4); the port
    moves by 1.0e-3 to 1.7e-3 on those under its own nudge. A missing
    stop-gradient moves some leaf by 5.6e-3 (a netSDF leaf, tolerance
    1e-3) to several times its norm
    (`test_a_removed_stop_gradient_fails_the_gradient_check`).

    Not every key that passes `agree` is this clean: of 22 passing keys
    read, 102, 106 and 111 at 2 CPU threads gave 1.2e-2, 1.7e-2 and 1.6e-3
    on articulation and encoder leaves with a forward that agrees like
    any other's, an event `agree` does not see and that was not traced.
    The test takes the first key that passes, which was 22 at every
    thread count tried."""
    gaps = gradient_gaps(flat_tree(step["tgrads"]),
                         flat_tree(numpy_tree(step["jgrads"])))
    assert len(gaps) > 40
    bad = {"/".join(p): g for p, g in gaps.items() if g > leaf_tolerance(p)}
    assert not bad, bad


@contextlib.contextmanager
def without_stop_gradient(file_suffix, function):
    """Inside the block `Tensor.detach()` returns its tensor unchanged
    where it is called from `function` of the port's file `file_suffix`:
    the stop-gradients of that function are gone, every other one stays."""
    real = torch.Tensor.detach

    def detach(self):
        code = sys._getframe(1).f_code
        if code.co_name == function and \
                code.co_filename.endswith(file_suffix):
            return self
        return real(self)
    torch.Tensor.detach = detach
    try:
        yield
    finally:
        torch.Tensor.detach = real


# (file, function) of the port with a stop-gradient of the JAX package's
# list that the training forward passes through
STOP_GRADIENT_SITES = [
    ("models/animal.py", "forward"),                  # rot_prob, logit target
    ("geometry/skinning.py", "estimate_bones"),
    ("geometry/skinning.py", "skinning"),
    ("predictors/instance.py", "get_bones"),
    ("predictors/base.py", "sdf_reg_losses"),
]


@pytest.mark.parametrize("site", STOP_GRADIENT_SITES,
                         ids=[f"{f}:{fn}" for f, fn in STOP_GRADIENT_SITES])
def test_a_removed_stop_gradient_fails_the_gradient_check(pair, step, site):
    """The check of `test_gradient_tree_matches_jax` has the margin to see
    the fault it exists for: with the stop-gradients of one function of
    the port removed, on the same key, some leaf leaves the JAX tree by
    more than three times its tolerance. Read on key 22, as multiples of
    the leaf's tolerance: `forward` 4.9e5 (the hypothesis probability and
    the logit target), `estimate_bones` 35, `skinning` 56, `get_bones` 129,
    `sdf_reg_losses` 5.6 (the eikonal term's surface points; its loss
    weight is 0.01)."""
    pair.reset()
    noise = pair.noise(jax.random.PRNGKey(step["seed"]))
    with without_stop_gradient(*site):
        loss, _ = pair.tm.forward(pair.tbatch, IT, None, pair.tphase,
                                  noise=noise)
        loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(step["tloss"]),
                               rtol=1e-6)
    gaps = gradient_gaps(flat_tree(export_jax_grads(pair.tm)),
                         flat_tree(numpy_tree(step["jgrads"])))
    pair.reset()
    worst = max(g / leaf_tolerance(p) for p, g in gaps.items())
    assert worst > 3, worst


def test_vit_parameters_have_no_grad(pair, step):
    """The frozen ViT is outside autograd: `requires_grad` False, `grad`
    None; every other parameter the phase uses has a gradient."""
    vit = [n for n, _p in pair.tm.named_parameters() if ".ViT." in n]
    assert len(vit) > 50
    for n, p in pair.tm.named_parameters():
        if ".ViT." in n:
            assert not p.requires_grad and n in step["no_grad"], n
    rest = [n for n in step["no_grad"] if ".ViT." not in n]
    assert all(n.startswith("netInstance.netDeform.") for n in rest), rest


def test_one_adam_step_matches_jax(pair, step):
    """The parameters after one step of `make_optimizer` on both sides from
    the same weights (lr 1e-4; Adam's first update is lr·g/(|g| + 1e-8),
    ±1e-4 per entry wherever |g| is well above 1e-8): entries within 2e-6,
    2% of one update, except at most 1% of a leaf's entries whose
    gradient is itself of the order of eps, where the update is any value
    between ±1e-4 (2 of 1,632 seen in netDINO's in-layer, 9 of 131,072
    in the encoder's key convolution, 1 of 13,056 in netSDF's in-layer;
    a small leaf such as a 32-entry bias may have one); none moves by more
    than 2.1e-4 from the reference. The frozen ViT does not move."""
    pair.reset()
    tx = jmake_optimizer(pair.jm, pair.jp)
    updates, _ = tx.update(step["jgrads"], tx.init(pair.jp), pair.jp)
    want = flat_tree(numpy_tree(optax.apply_updates(pair.jp, updates)))
    before = flat_tree(export_jax_params(pair.tm))
    opt = make_optimizer(pair.tm)
    assert set(opt.optimizers) == {"base", "instance"}
    grouped = {id(p) for o in opt.optimizers.values()
               for g in o.param_groups for p in g["params"]}
    for n, p in pair.tm.named_parameters():
        assert (id(p) in grouped) == (".ViT." not in n), n
    train_step(pair.tm, opt, pair.tbatch, IT, None, pair.tphase,
               noise=pair.noise(jax.random.PRNGKey(step["seed"])))
    after = flat_tree(export_jax_params(pair.tm))
    moved = 0
    for path, leaf in want.items():
        if "ViT" in path:
            np.testing.assert_array_equal(after[path], before[path])
            continue
        diff = np.abs(after[path] - leaf)
        assert diff.max() <= 2.1e-4, "/".join(path)
        assert (diff > 2e-6).sum() <= max(1, 0.01 * diff.size), \
            ("/".join(path), int((diff > 2e-6).sum()), diff.size)
        moved += int(np.any(after[path] != before[path]))
    assert moved > 40
    pair.reset()


def test_four_step_loss_trajectory_matches_jax(pair):
    """Four Adam steps from the same weights, each on the next key on which
    the two packages' discrete decisions agree (a key that disagrees is
    skipped on both sides without a step). After the first step the two
    models differ by up to one Adam update in entries whose gradient is of
    the order of eps: the articulation then differs by ~1.5e-3 on every
    key and a few dozen silhouette pixels by more than 2e-2. So the first
    step is taken on a key without a flipped face (pixels within 2e-2: a
    flip there would double the entries whose first update differs), and
    on the later steps only the feet are told apart (`same_feet`).

    The loss of step 1 within rtol 1e-4 (5e-7 seen), step 2 within 1e-3
    (2.0e-5 to 7.7e-5 seen over 1, 2, 4 and 8 CPU threads), steps 3 and 4
    within 5e-2 (3.8e-5 to 2.8e-3 and 1.9e-3 to 1.6e-2 seen). Adam's first
    steps move every entry by ±lr whatever its gradient's size, so the
    float32 differences of the two packages grow by an order of magnitude
    per step — the chaos `scripts/chaos_probe.py` measures (4.8% at step 5
    from a 1e-6 change). A wrong learning rate, eps or bias correction
    shows at step 2."""
    pair.reset()
    tx = jmake_optimizer(pair.jm, pair.jp)
    params, state = pair.jp, tx.init(pair.jp)
    opt = make_optimizer(pair.tm)
    jlosses, tlosses = [], []
    for seed in range(MAX_KEYS):
        rng = jax.random.PRNGKey(seed)
        (jloss, (_m, jaux)), grads = pair.value_and_grad(params, rng)
        tloss, (_tm, taux) = pair.tm.forward(
            pair.tbatch, IT, None, pair.tphase, noise=pair.noise(rng))
        if not (agree(jaux, taux, arti_atol=2e-3, pixel_atol=2e-2)
                if not jlosses else same_feet(pair, jaux, taux)):
            continue
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        tloss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        jlosses.append(float(jloss))
        tlosses.append(float(tloss.detach()))
        if len(jlosses) == 4:
            break
    pair.reset()
    assert len(jlosses) == 4, f"only {len(jlosses)} keys of {MAX_KEYS} agree"
    rel = np.abs(np.array(tlosses) / np.array(jlosses) - 1)
    assert (rel <= TRAJECTORY_RTOL).all(), (tlosses, jlosses, rel)


def test_train_step_under_anomaly_detection(pair):
    """One step from a generator (no `Noise`) under
    `torch.autograd.set_detect_anomaly`: no NaN or inf arises anywhere in
    the backward (the `torch.where` guards of resolve, the barycentrics and
    the normalizations hold), the loss is finite, the plain versions run
    on the CPU (no kernel launch is counted) and the parameters move."""
    pair.reset()
    opt = make_optimizer(pair.tm)
    gen = torch.Generator().manual_seed(0)
    counts = (fused_mlp.fused_mlp_fwd.launches,
              fused_mlp.fused_mlp_bwd.launches,
              resolve_cuda.resolve_bwd.launches)
    before = {k: v.clone() for k, v in pair.tm.state_dict().items()}
    with torch.autograd.set_detect_anomaly(True):
        met = train_step(pair.tm, opt, pair.tbatch, IT, gen, pair.tphase)
    assert np.isfinite(float(met["loss"]))
    assert counts == (fused_mlp.fused_mlp_fwd.launches,
                      fused_mlp.fused_mlp_bwd.launches,
                      resolve_cuda.resolve_bwd.launches)
    after = pair.tm.state_dict()
    assert any(not torch.equal(before[k], after[k]) for k in before)
    assert all(torch.isfinite(v).all() for v in after.values()
               if v.is_floating_point())
    assert all(p.grad is None for p in pair.tm.parameters())
    pair.reset()
