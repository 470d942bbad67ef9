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
decisions and at two ties of the float32 formulation (`step`), never at
the gap between the packages.
"""
import contextlib
import sys

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from animals3d_tpu.geometry import skinning as jskinning
from animals3d_tpu.trainer import make_optimizer as jmake_optimizer
from animals3d_tpu_torch.convert_jax import (export_jax_grads,
                                             export_jax_params)
from animals3d_tpu_torch.geometry import skinning as tskinning
from animals3d_tpu_torch.ops import fused_mlp, resolve_cuda
from animals3d_tpu_torch.ops.antialias import (_pair_blend,
                                               silhouette_pairs)
from animals3d_tpu_torch.ops.rasterize_cuda import rasterize_cuda
from animals3d_tpu_torch.precision import set_mixed_precision
from animals3d_tpu_torch.render.camera import xfm_points as tpu_xfm
from animals3d_tpu_torch.trainer import make_optimizer, train_step
import torch_search
from torch_parity import (TRAIN_OVERRIDES, batch_to, build_pair,
                          fake_batch_np, flat_tree, jax_noise, numpy_tree)

IT = 50000
TRAJECTORY_RTOL = (1e-4, 1e-3, 5e-2, 5e-2)   # per step; see the test
MAX_KEYS = 150      # keys tried before giving up (about 1 in 15 agrees)
DARK = 0.1          # scale of the image and feature targets (see above)
GRAD_TOL = 1e-3     # |Δ| / ‖leaf‖ of a gradient leaf against the JAX tree
ULP = 2.0 ** -23    # one float32 ulp, relative: the nudge of a parameter
# the first two layers of the two fields that are sampled per pixel through
# a harmonic embedding: one ReLU unit that switches at one pixel shows here
NOISY_LEAVES = (("netBase", "netDINO", "in_layer"),
                ("netBase", "netDINO", "mlp", "layer_0"),
                ("netInstance", "netTexture", "in_layer"),
                ("netInstance", "netTexture", "mlp", "layer_0"))
NOISY_TOL = 5e-3


def forward_agrees(jaux, taux, arti_atol=1e-4, pixel_atol=1e-3):
    """The discrete decisions of one forward that its outputs show agree:
    feet (articulation, where the phase has it, within `arti_atol`;
    another foot moves it by ~0.1) and winning faces (rendered mask, image
    and features within `pixel_atol` on every pixel; a flipped face moves
    them by ~0.1)."""
    def gap(k):
        return np.abs(np.asarray(jaux[k])
                      - taux[k].detach().numpy()).max()
    if (jaux["arti_params"] is None) != (taux["arti_params"] is None):
        return False
    arti_ok = taux["arti_params"] is None or gap("arti_params") <= arti_atol
    return arti_ok and all(gap(k) <= pixel_atol
                           for k in ("mask_pred", "image_pred", "dino_pred"))


def agree(jaux, taux, arti_atol=1e-4, pixel_atol=1e-3):
    """The discrete decisions of one forward agree: those its outputs show
    (`forward_agrees`) and the branch the antialias pass takes at every
    silhouette pair, which they do not (`same_blend_branches`)."""
    return forward_agrees(jaux, taux, arti_atol, pixel_atol) \
        and same_blend_branches(jaux, taux)


def blend_branches(pairs):
    """The branch `ops.antialias._pair_blend` takes at each silhouette pair
    of `silhouette_pairs`: the edge of the inside triangle that the segment
    between the two pixel centres crosses first (the minimum of the three
    crossing parameters t_i), whether t > 0 (t is clipped to [0, 1]) and
    whether t > 1/2 (which pixel is blended), as one code; -1 where the
    pair crosses no edge or the slot is empty."""
    iif = pairs["inside_is_first"][..., None]
    e_in = torch.where(iif, pairs["e_p"], pairs["e_q"])
    e_out = torch.where(iif, pairs["e_q"], pairs["e_p"])
    den = e_in - e_out
    t_i = torch.where(e_out < 0, e_in / torch.where(
        den.abs() > 1e-12, den, torch.full_like(den, 1e-12)),
        torch.full_like(den, float("inf")))
    t, edge = t_i.min(-1)
    code = edge + 3 * (t > 0).long() + 6 * (t > 0.5).long()
    return torch.where(torch.isfinite(t) & pairs["slot_ok"], code, -1)


def posed_clip(aux):
    """The posed clip-space vertices of a forward's aux (either package)."""
    t = lambda a: a if isinstance(a, torch.Tensor) else \
        torch.from_numpy(np.asarray(a))
    return tpu_xfm(t(aux["shape"].v_pos).detach(), t(aux["mvp"]).detach())


def blend_ties(jaux, taux):
    """The silhouette pairs of the port's render at which `blend_branches`
    differs between the port's posed vertices and the JAX package's:
    (rast, port v_clip, JAX v_clip, (n, 2) (image, slot) indices)."""
    shape = taux["shape"]
    res = tuple(taux["mask_pred"].shape[-2:])
    with torch.no_grad():
        tv, jv = posed_clip(taux), posed_clip(jaux)
        rast = rasterize_cuda(tv, shape.t_pos_idx, shape.f_valid, res,
                              v_pos0=shape.v_pos[0])
        differ = blend_branches(silhouette_pairs(rast, tv, shape.t_pos_idx)) \
            != blend_branches(silhouette_pairs(rast, jv, shape.t_pos_idx))
    return rast, tv, jv, torch.nonzero(differ)


def same_blend_branches(jaux, taux):
    """The antialias pass takes the same branch (`blend_branches`) at every
    silhouette pair of the port's render whether the edge functions come
    from the port's posed vertices or from the JAX package's.

    The packages' posed vertices differ by ~1e-5 (float32 rounding through
    the ViT and the skinning), and so do the crossing parameters t. Each
    branch point is continuous in the forward (the blend weights agree) but
    not in the gradient: where a pair's segment leaves the triangle within
    that much of a vertex, the two packages take t from two different
    edges, and the gradient of the silhouette goes to other vertices
    (`test_a_blend_branch_tie_moves_the_silhouette_gradient`)."""
    return len(blend_ties(jaux, taux)[3]) == 0


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


def texture_relu_layers(tm):
    """{flax scope path under netInstance: port module name} of the texture
    field's layers whose outputs go through a ReLU: its in-layer and every
    layer of its MLP but the last."""
    layers = {("netTexture", "in_layer"): "netInstance.netTexture.in_layer"}
    for i in range(tm.netInstance.netTexture.mlp.num_layers - 1):
        layers[("netTexture", "mlp", f"layer_{i}")] = \
            f"netInstance.netTexture.mlp.layer_{i}"
    return layers


def rgb_pixels(batch, taux):
    """(B·F, H, W) bool: the pixels the rgb loss reads, as the port's
    `AnimalModel` picks them (rendered and target masks, eroded by one
    pixel)."""
    mask_gt = (torch.from_numpy(batch["masks"][:, :, 0]) > 0.9).float()
    both = ((taux["mask_pred"].detach()
             * torch.from_numpy(batch["mask_valid"])) > 0).float() * mask_gt
    B, Fr, H, W = both.shape
    eroded = F.avg_pool2d(both.reshape(B * Fr, 1, H, W), 3, stride=1,
                          padding=1, count_include_pad=True)
    return eroded[:, 0] > 0.99


def worst_multiple(gaps):
    """The largest gap of `gradient_gaps`-style {path: gap} in units of the
    leaf's tolerance."""
    return max(g / leaf_tolerance(p) for p, g in gaps.items())


@contextlib.contextmanager
def torch_threads(n):
    """Inside the block torch runs on n CPU threads (None: unchanged)."""
    old = torch.get_num_threads()
    if n:
        torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(old)


class Pair:
    """Both packages' models with the same weights (`build_pair`, or
    `models` from another `Pair`), the dark batch, and the training
    forward at iteration `it` (default `IT`)."""

    def __init__(self, it=IT, overrides=TRAIN_OVERRIDES, models=None,
                 batch_size=2):
        set_mixed_precision(None)
        self.it = it
        self.overrides = list(overrides)
        self.jm, self.jp, self.tm = models or build_pair(overrides)
        self.init_state = {k: v.clone() for k, v in
                           self.tm.state_dict().items()}
        self.phase = self.jm.phase_for_iter(it)
        self.tphase = self.tm.phase_for_iter(it)
        self.batch = fake_batch_np(0, B=batch_size)
        for k in ("images", "dino_features"):
            self.batch[k] = (self.batch[k] * DARK).astype(np.float32)
        self.jbatch = batch_to(self.batch, jnp.asarray)
        self.tbatch = batch_to(self.batch, torch.from_numpy)
        grid, _, _ = self.jm.grid_for_phase(self.phase)
        self.value_and_grad = jax.jit(jax.value_and_grad(
            lambda p, rng: self.jm.forward(p, self.jbatch, it, rng,
                                           self.phase, grid), has_aux=True))
        self.tie_keys = []        # keys skipped for a blend-branch tie
        self.relu_keys = []       # keys skipped for a texture ReLU tie
        self.relu_layers = texture_relu_layers(self.tm)

        def texture_preactivations(p, rng):
            caught = {}

            def catch(next_fun, args, kwargs, ctx):
                out = next_fun(*args, **kwargs)
                path = tuple(ctx.module.scope.path)
                if ctx.method_name == "__call__" \
                        and path in self.relu_layers:
                    caught.setdefault(self.relu_layers[path], []).append(out)
                return out
            with nn.intercept_methods(catch):
                self.jm.forward(p, self.jbatch, it, rng, self.phase, grid)
            return caught
        self.jax_preactivations = jax.jit(texture_preactivations)

    def port_preactivations(self, rng):
        """The port's counterpart of `jax_preactivations` (the texture
        field's ReLU inputs in one forward, by port module name)."""
        caught = {}
        mods = dict(self.tm.named_modules())
        hooks = [mods[n].register_forward_hook(
            lambda m, i, o, n=n: caught.setdefault(n, []).append(o.detach()))
            for n in self.relu_layers.values()]
        try:
            with torch.no_grad():
                self.tm.forward(self.tbatch, self.it, None, self.tphase,
                                noise=self.noise(rng))
        finally:
            for h in hooks:
                h.remove()
        return caught

    def relu_switches(self, rng, taux):
        """The texture field's ReLU decisions that differ between the two
        packages at the pixels of the rgb loss (`rgb_pixels`): {port module
        name: ((B, H, W, nf) bool, JAX's pre-activations)}, for the layers
        with at least one."""
        jpre = self.jax_preactivations(self.jp, rng)
        tpre = self.port_preactivations(rng)
        where = rgb_pixels(self.batch, taux)[..., None]
        out = {}
        for name in self.relu_layers.values():
            (j,), (t,) = jpre[name], tpre[name]      # one call per forward
            j = torch.from_numpy(np.array(j))
            switched = ((j > 0) != (t > 0)) & where
            if switched.any():
                out[name] = (switched, j)
        return out

    @contextlib.contextmanager
    def jax_relu_decisions(self, switches):
        """Inside the block the port's texture field takes JAX's
        pre-activation values at the entries of `switches`
        (`relu_switches`), so its ReLUs there decide as JAX's did; the
        gradient through those entries stays the port's."""
        mods = dict(self.tm.named_modules())
        hooks = [mods[n].register_forward_hook(
            lambda m, i, o, sw=sw, j=j: torch.where(sw, o + (j - o).detach(),
                                                    o))
            for n, (sw, j) in switches.items()]
        try:
            yield
        finally:
            for h in hooks:
                h.remove()

    def port_grads(self, rng):
        """The port's gradient tree at `rng`, flat, in the flax layout; the
        parameters' `.grad` are left empty."""
        return self.port_grads_aux(rng)[0]

    def port_grads_aux(self, rng, nudge=None):
        """The port's gradient tree (flat, flax layout) and forward aux at
        `rng`. With `nudge`, every trained parameter is first multiplied by
        1 ± `ULP` with random signs from that seed, and restored after."""
        noise = self.noise(rng)
        if nudge is not None:
            gen = torch.Generator().manual_seed(nudge)
            with torch.no_grad():
                for name, p in self.tm.named_parameters():
                    if ".ViT." not in name:
                        up = torch.rand(p.shape, generator=gen) > 0.5
                        p.mul_(1 + (up.float() * 2 - 1) * ULP)
        self.tm.zero_grad(set_to_none=True)
        loss, (_met, aux) = self.tm.forward(self.tbatch, self.it, None,
                                            self.tphase, noise=noise)
        loss.backward()
        grads = flat_tree(export_jax_grads(self.tm))
        if nudge is None:
            self.tm.zero_grad(set_to_none=True)
        else:
            self.reset()
        return grads, aux

    def jax_grads_aux(self, rng, nudge=None):
        """The same for the JAX package, its parameters nudged with numpy
        random signs from `nudge`."""
        params = self.jp
        if nudge is not None:
            r = np.random.default_rng(nudge)
            params = jax.tree_util.tree_map(
                lambda x: jnp.asarray(np.asarray(x) * (
                    1 + (r.integers(0, 2, x.shape) * 2 - 1)
                    * np.float32(ULP)).astype(np.float32)), params)
        (_l, (_m, aux)), grads = self.value_and_grad(params, rng)
        return flat_tree(numpy_tree(grads)), aux

    def relu_tie(self, rng, taux):
        """Whether the texture field's ReLU decisions that differ between
        the packages (`relu_switches`) matter: taking JAX's decisions there
        moves a leaf of the port's gradient tree by more than its
        tolerance."""
        switches = self.relu_switches(rng, taux)
        if not switches:
            return False
        own = self.port_grads(rng)
        with self.jax_relu_decisions(switches):
            imposed = self.port_grads(rng)
        return worst_multiple({p: np.linalg.norm(imposed[p] - g)
                               / np.linalg.norm(g) for p, g in own.items()
                               if np.linalg.norm(g) > 0}) > 1

    def reset(self):
        self.tm.load_state_dict(self.init_state)
        self.tm.zero_grad(set_to_none=True)

    def other_views_agree(self, rng, jout, tout):
        """Whether the decisions of renders beyond the input view agree
        (`search_here`); MagicPony renders none. `jout` and `tout` are
        each package's (metrics, aux)."""
        return True

    def noise(self, rng):
        """The JAX forward's draws for `rng`; the surface indices need the
        jittered prior's vertex count, which is exact between the two
        packages (`tests/test_torch_prior.py`)."""
        K = self.tm.netInstance.num_pose_hypos
        n = self.batch["images"].shape[0]
        first = jax_noise(rng, n, K)
        grid, v_cap, f_cap = self.tm.grid_for_phase(self.tphase)
        with torch.no_grad():
            prior, _sdf, *_ = self.tm.forward_base(
                grid, v_cap, f_cap, jitter=first.jitter_u, batch=self.tbatch)
        return jax_noise(rng, n, K, int(prior.num_verts))


@pytest.fixture(scope="module")
def pair():
    return Pair()


def search_here(pair):
    """One forward and backward of both packages at `pair.it`, at the
    first key on which their discrete decisions agree: feet and faces
    (`forward_agrees`), the antialias blend branches
    (`same_blend_branches`) and, where it matters, the texture field's
    ReLUs (`Pair.relu_tie`). Keys skipped for one of the last two ties are
    kept in `pair.tie_keys` and `pair.relu_keys`. Runs in this process;
    the tests call `search_step`, which runs it in a child."""
    pair.reset()
    for seed in range(MAX_KEYS):
        rng = jax.random.PRNGKey(seed)
        (jloss, (jmet, jaux)), jgrads = pair.value_and_grad(pair.jp, rng)
        tloss, (tmet, taux) = pair.tm.forward(
            pair.tbatch, pair.it, None, pair.tphase, noise=pair.noise(rng))
        if not forward_agrees(jaux, taux):
            continue
        if not same_blend_branches(jaux, taux) or \
                not pair.other_views_agree(rng, (jmet, jaux), (tmet, taux)):
            pair.tie_keys.append(seed)
            continue
        if not pair.relu_tie(rng, taux):
            break
        pair.relu_keys.append(seed)
    else:
        pytest.fail(f"no key of {MAX_KEYS} without a foot tie or a face flip")
    tloss.backward()
    grads = export_jax_grads(pair.tm)
    none = [n for n, p in pair.tm.named_parameters() if p.grad is None]
    pair.tm.zero_grad(set_to_none=True)
    return dict(seed=seed, jloss=jloss, jmet=jmet, jaux=jaux, jgrads=jgrads,
                tloss=tloss.detach(), tmet=tmet, taux=taux, tgrads=grads,
                no_grad=none)


def child_search(its, overrides):
    """`search_here` at each iteration of `its` on one pair of models
    built from `overrides` (`torch_search`'s child calls this): {it:
    (the step, tie keys, ReLU keys)}, or {it: the failure's message}."""
    out, first = {}, None
    for it in its:
        pair = Pair(it, overrides, models=first and (first.jm, first.jp,
                                                     first.tm))
        first = first or pair
        try:
            out[it] = (search_here(pair), pair.tie_keys, pair.relu_keys)
        except pytest.fail.Exception as e:
            out[it] = f"iteration {it}: {e}"
    return out


def search_steps(pairs, module="test_torch_train"):
    """`search_here` for each {iteration: Pair} (all from one set of
    overrides), run in one child process with passive OpenMP waits
    (`torch_search`: under tier-1's six workers a rejected key costs
    ~35 s of spinning threads here, ~1 s there). Each pair gets its
    `tie_keys` and `relu_keys`; returns {it: step, or the failure's
    message}. `module` names the test module whose `child_search` builds
    the pairs there. The step's JAX values come back as numpy arrays and the
    port's as detached tensors: the same numbers, and the tests that
    recompute a step here hold them to it (`tloss`, rtol 1e-6)."""
    overrides = {tuple(p.overrides) for p in pairs.values()}
    assert len(overrides) == 1, "one set of overrides per child"
    got = torch_search.in_child(module, list(pairs), list(overrides.pop()))
    out = {}
    for it, pair in pairs.items():
        if isinstance(got[it], str):
            out[it] = got[it]
            continue
        out[it], pair.tie_keys, pair.relu_keys = got[it]
    return out


def search_step(pair):
    """`search_here` at `pair.it`, run in a child (`search_steps`)."""
    s = search_steps({pair.it: pair})[pair.it]
    if isinstance(s, str):
        pytest.fail(s)
    return s


@pytest.fixture(scope="module")
def step(pair):
    """`search_step` at `IT`."""
    return search_step(pair)


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

    Keys whose forward agrees can still differ by 1e-2 on articulation
    and encoder leaves: 106 and 102 at 2 torch threads (16.7 and 11.6
    tolerances). Both are ties of the float32 formulation (`ROADMAP.md`
    C), which the `step` fixture skips: a silhouette pair at a branch
    point of the antialias blend (106; `same_blend_branches`) and a ReLU
    of the texture field that takes another side in each package at a
    pixel of the rgb loss (102; `Pair.relu_tie`). Keys 111 at 2 threads
    and 76 at 1 read 1.6 and 2.3 tolerances on an encoder leaf with every
    decision the same: keys one ulp from a decision, where a package's
    own tree moves as far
    (`test_an_encoder_gap_is_as_large_as_a_one_ulp_nudge`). The fixture
    takes key 22 at 1, 2, 4 and 8 threads."""
    gaps = gradient_gaps(flat_tree(step["tgrads"]),
                         flat_tree(numpy_tree(step["jgrads"])))
    assert len(gaps) > 40
    bad = {"/".join(p): g for p, g in gaps.items() if g > leaf_tolerance(p)}
    assert not bad, bad


def _blend_weight_grad(rast, v_clip, faces, b, k):
    """The blend weights of silhouette pair k of image b (the sum of the two
    pixels' weights) and their gradient with respect to v_clip."""
    v = v_clip.clone().requires_grad_(True)
    pr = silhouette_pairs(rast, v, faces)
    w_first, w_second = _pair_blend(pr["inside_is_first"], pr["e_p"],
                                    pr["e_q"], pr["slot_ok"])
    w = w_first[b, k] + w_second[b, k]
    w.backward()
    return float(w.detach()), v.grad


def test_a_blend_branch_tie_moves_the_silhouette_gradient(pair, step):
    """The tie of the float32 formulation that `same_blend_branches` keeps
    out of the keys: at a silhouette pair whose crossing parameter t lies
    within the packages' rounding difference of a branch point of
    `_pair_blend` (t = 1/2, t = 0, or two edges crossed at one t), a
    vertex difference of that size moves the blend weight (the forward)
    continuously but its gradient with respect to the vertices by a jump.
    Seen between the packages on key 106 at two torch threads
    (`tests/torch_tie_probe.py`): 16.7 tolerances on the articulation
    leaves, through the mask loss; the mask gradient through the
    antialias pass is JAX's to 2.4e-7 when the port's antialias is fed
    JAX's rasterization and posed vertices, and 2.6e-2 from it when fed
    the port's posed vertices. Which keys carry such a pair depends on the
    CPU thread count (none in 150 keys at 4 threads), so the test makes one on
    the step's key: it moves the inside triangle of the pair whose t is
    nearest 1/2 across t = 1/2 by screen distance d, and requires
    `blend_branches` to tell the two vertex sets apart at that pair, the
    weight to move by at most 2d, and its gradient to jump by more than a
    tenth of its norm. Keys on which the search of the `step` fixture met
    such a pair between the packages are held to the same."""
    taux = step["taux"]
    shape = taux["shape"]
    faces = shape.t_pos_idx
    res = tuple(taux["mask_pred"].shape[-2:])
    with torch.no_grad():
        tv = posed_clip(taux)
        rast = rasterize_cuda(tv, faces, shape.f_valid, res,
                              v_pos0=shape.v_pos[0])
        pr = silhouette_pairs(rast, tv, faces)
    iif = pr["inside_is_first"][..., None]
    e_in = torch.where(iif, pr["e_p"], pr["e_q"])
    e_out = torch.where(iif, pr["e_q"], pr["e_p"])
    t = torch.where(e_out < 0, e_in / (e_in - e_out),
                    torch.full_like(e_in, float("inf"))).amin(-1)
    t = torch.where(pr["slot_ok"] & torch.isfinite(t), t,
                    torch.full_like(t, float("inf")))
    b, k = divmod(int((t - 0.5).abs().argmin()), t.shape[1])
    d = 2 * abs(float(t[b, k]) - 0.5) + 1e-4
    # move the inside triangle along the pair's segment, across t = 1/2
    W = res[1]
    p, q = int(pr["p_lin"][b, k]), int(pr["q_lin"][b, k])
    axis = 0 if q - p == 1 else 1
    inside = bool(pr["inside_is_first"][b, k])
    fid = rast.face_id.reshape(rast.face_id.shape[0], -1)[b]
    tri = faces[int(fid[p if inside else q]) - 1]
    sign = 1.0 if (float(t[b, k]) < 0.5) == inside else -1.0
    moved = tv.clone()
    moved[b, tri, axis] += sign * d * 2 * moved[b, tri, 3] / res[1 - axis]
    with torch.no_grad():
        differ = blend_branches(silhouette_pairs(rast, tv, faces)) \
            != blend_branches(silhouette_pairs(rast, moved, faces))
    assert bool(differ[b, k])
    cases = [(rast, tv, moved, b, k, 2 * d)]
    for seed in pair.tie_keys:
        rng = jax.random.PRNGKey(seed)
        (_l, (_m, jaux)), _g = pair.value_and_grad(pair.jp, rng)
        pair.reset()
        with torch.no_grad():
            _t, (_tm, kaux) = pair.tm.forward(
                pair.tbatch, IT, None, pair.tphase, noise=pair.noise(rng))
        r_, tv_, jv_, ties = blend_ties(jaux, kaux)
        assert len(ties) > 0
        cases += [(r_, tv_, jv_, i, j, 1e-3) for i, j in ties.tolist()]
    for r_, va, vb, i, j, wtol in cases:
        w_a, g_a = _blend_weight_grad(r_, va, faces, i, j)
        w_b, g_b = _blend_weight_grad(r_, vb, faces, i, j)
        jump = float((g_a - g_b).norm() / max(g_a.norm(), g_b.norm()))
        print(f"image {i}, pair {j}: weight {w_a:.6f} / {w_b:.6f}, "
              f"gradient jump {jump:.3f} of its norm")
        assert abs(w_a - w_b) <= wtol
        assert jump > 0.1


# where the texture ReLU tie was first seen: this key at this many torch
# threads (the JAX side does not depend on them)
RELU_TIE_KEY, RELU_TIE_THREADS = 102, 2


def test_a_texture_relu_tie_moves_the_rgb_gradient(pair, step):
    """The tie of the float32 formulation that `Pair.relu_tie` keeps out of
    the keys: a ReLU of the texture field whose input lies within the
    packages' rounding difference of zero at a pixel of the rgb loss takes
    another side in each package (`Pair.relu_switches` reads both
    packages' pre-activations). The rendered colour moves continuously,
    but the field's gradient with respect to its sample position (a
    harmonic embedding of up to 2^9 cycles) changes at that pixel, and a
    leaf of the tree is the small remainder of per-pixel terms.

    On the key where it was seen, and on every key the `step` fixture
    skipped for it: the forward agrees, the blend branches agree, the
    packages' ReLU decisions differ at some pixel of the rgb loss, the
    port's tree is more than a tolerance from JAX's, and with JAX's
    decisions taken at those entries alone (`Pair.jax_relu_decisions`)
    every leaf is within its tolerance."""
    cases = [(RELU_TIE_KEY, RELU_TIE_THREADS)] \
        + [(seed, None) for seed in pair.relu_keys]
    for seed, threads in cases:
        with torch_threads(threads):
            rng = jax.random.PRNGKey(seed)
            (_l, (_m, jaux)), jgrads = pair.value_and_grad(pair.jp, rng)
            with torch.no_grad():
                _t, (_tm, taux) = pair.tm.forward(
                    pair.tbatch, IT, None, pair.tphase,
                    noise=pair.noise(rng))
            assert forward_agrees(jaux, taux) \
                and same_blend_branches(jaux, taux), seed
            switches = pair.relu_switches(rng, taux)
            want = flat_tree(numpy_tree(jgrads))
            before = worst_multiple(gradient_gaps(pair.port_grads(rng), want))
            with pair.jax_relu_decisions(switches):
                after = worst_multiple(gradient_gaps(pair.port_grads(rng),
                                                     want))
        n = sum(int(sw.sum()) for sw, _j in switches.values())
        print(f"key {seed} ({threads or torch.get_num_threads()} "
              f"threads): {n} ReLU decisions differ; the port's tree "
              f"{before:.2f} tolerances from JAX's, {after:.2f} with JAX's "
              "decisions taken")
        assert n > 0
        assert before > 1 and after <= 1


# keys whose forward and decisions agree and whose tree is more than a
# tolerance from JAX's on an encoder leaf: (key, torch threads, the
# package nudged, the nudge seed of `Pair.port_grads_aux` and
# `Pair.jax_grads_aux` that keeps every decision of that package the same)
ENCODER_GAP_KEYS = [(111, 2, "port", 5), (76, 1, "jax", 1)]
ENCODER_LEAF = ("netInstance", "netEncoder", "final_layer_patch_key",
                "norm_0", "scale")


def test_an_encoder_gap_is_as_large_as_a_one_ulp_nudge(pair):
    """A property of the float32 formulation, not a fault of the port. On
    keys 111 (2 torch threads) and 76 (1 thread) the forward agrees, the
    feet, faces and antialias blend branches are the same in both
    packages, and yet the LayerNorm scale of the encoder's patch-key head,
    a sum over B × 1,024 tokens of the articulation branch's cotangent,
    is 1.6 and 2.3 tolerances from JAX's tree. Nudging every parameter of
    one package by one float32 ulp (random signs) moves that package's own
    tree on the leaf as far as the gap or farther: the port's by 1.6
    tolerances on key 111, JAX's by 3.4 on key 76
    (`tests/torch_grad_noise.py --nudges 6`). These keys sit one ulp from
    a decision: of six such nudges, five of the port's flip one on key
    111, and all six of the port's and five of JAX's on key 76. The test
    holds each key to it: the packages agree, the gap exceeds the leaf's
    tolerance, and the named package, nudged so that its decisions stay
    the same, moves by at least the gap."""
    tol = leaf_tolerance(ENCODER_LEAF)

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))
    for seed, threads, who, nudge in ENCODER_GAP_KEYS:
        with torch_threads(threads):
            rng = jax.random.PRNGKey(seed)
            want, jaux = pair.jax_grads_aux(rng)
            got, taux = pair.port_grads_aux(rng)
            assert agree(jaux, taux), seed
            if who == "port":
                moved, maux = pair.port_grads_aux(rng, nudge)
                same = agree(jaux, maux)
                own = got
            else:
                moved, maux = pair.jax_grads_aux(rng, nudge)
                same = agree(maux, taux)
                own = want
        gap = rel(got[ENCODER_LEAF], want[ENCODER_LEAF])
        step = rel(moved[ENCODER_LEAF], own[ENCODER_LEAF])
        print(f"key {seed} ({threads} threads): gap {gap / tol:.2f} "
              f"tolerances, {who} nudged ({nudge}) moves {step / tol:.2f}")
        assert same, seed
        assert gap > tol
        assert step >= gap


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
