"""The port's textures, environment light and BSDF helpers against the JAX
package on the CPU (`render/texture.py`, `render/light.py` from
`LIGHT_MIN_RES` on, `ops/shading.py`), and `render_mesh` with an
environment light at 32². Inputs from seeded numpy; float32 on both
sides. Elementwise functions within 1e-6 (relative 1e-5 where a power or
a division amplifies rounding), the cubemap pipeline within 1e-5 (its
sums run in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animals3d_tpu.ops import shading as jsh
from animals3d_tpu.render import light as jlight
from animals3d_tpu.render import render as jrender
from animals3d_tpu.render import texture as jtex
from animals3d_tpu_torch.ops import shading as tsh
from animals3d_tpu_torch.precision import set_mixed_precision
from animals3d_tpu_torch.render import light as tlight
from animals3d_tpu_torch.render import render as trender
from animals3d_tpu_torch.render import texture as ttex
from test_torch_render import _port_mesh, scene  # noqa: F401 (a fixture)

R = np.random.default_rng


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def close(got, want, atol=1e-6, rtol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol)


def unit(r, shape):
    v = r.normal(size=shape)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


# ---- textures ------------------------------------------------------------

def test_build_mips_and_bilinear_match_jax():
    r = R(0)
    tex = r.uniform(0, 1, (12, 20, 3)).astype(np.float32)
    jm, tm = jtex.build_mips(jnp.asarray(tex)), ttex.build_mips(t(tex))
    assert len(jm) == len(tm) > 2
    for a, b in zip(tm, jm):
        close(a, b)
    uv = r.uniform(-0.2, 1.2, (5, 7, 2)).astype(np.float32)
    close(ttex.sample_bilinear(t(tex), t(uv)),
          jtex.sample_bilinear(jnp.asarray(tex), jnp.asarray(uv)))
    # the gradient to the texture
    w = r.normal(size=(5, 7, 3)).astype(np.float32)
    jg = jax.grad(lambda x: jnp.sum(jtex.sample_bilinear(x, jnp.asarray(uv))
                                    * w))(jnp.asarray(tex))
    tt = t(tex).requires_grad_(True)
    (ttex.sample_bilinear(tt, t(uv)) * t(w)).sum().backward()
    close(tt.grad, jg)


@pytest.mark.parametrize("lod", [None, 0.7, "per-sample"])
def test_sample_texture_matches_jax(lod):
    """Mipmapped sampling; the coarse mips reach the base size by a
    nearest resize with half-pixel centres."""
    r = R(1)
    tex = r.uniform(0, 1, (16, 16, 3)).astype(np.float32)
    uv = r.uniform(0, 1, (9, 2)).astype(np.float32)
    if lod == "per-sample":
        lod = r.uniform(0, 5, (9, 1)).astype(np.float32)
    jl = None if lod is None else jnp.asarray(lod)
    tl = None if lod is None else torch.as_tensor(lod)
    close(ttex.sample_texture(t(tex), t(uv), tl),
          jtex.sample_texture(jnp.asarray(tex), jnp.asarray(uv), jl))


def test_resize_nearest_matches_jax():
    r = R(2)
    m = r.uniform(0, 1, (3, 5, 2)).astype(np.float32)
    close(ttex._resize_nearest(t(m), (12, 20, 2)),
          jax.image.resize(jnp.asarray(m), (12, 20, 2), "nearest"), atol=0,
          rtol=0)


def test_checkerboard_and_cubemap_conversions_match_jax():
    np.testing.assert_array_equal(ttex.checkerboard((24, 40), 5),
                                  jtex.checkerboard((24, 40), 5))
    r = R(3)
    latlong = r.uniform(0, 1, (32, 64, 3)).astype(np.float32)
    cube_j = jtex.latlong_to_cubemap(jnp.asarray(latlong), 16)
    cube_t = ttex.latlong_to_cubemap(t(latlong), 16)
    assert cube_t.shape == (6, 16, 16, 3)
    close(cube_t, cube_j, atol=1e-5)
    close(ttex.cubemap_to_latlong(t(np.asarray(cube_j)), (16, 32)),
          jtex.cubemap_to_latlong(cube_j, (16, 32)), atol=1e-5)


# ---- the environment light -----------------------------------------------

def test_cube_tables_and_lut_match_jax():
    for res in (1, 4, 16):
        np.testing.assert_array_equal(tlight.cube_texel_dirs(res),
                                      jlight.cube_texel_dirs(res))
        np.testing.assert_array_equal(tlight.cube_texel_areas(res),
                                      jlight.cube_texel_areas(res))
    np.testing.assert_array_equal(tlight._hammersley(64),
                                  jlight._hammersley(64))
    np.testing.assert_array_equal(tlight._fg_lut_np(), jlight._fg_lut_np())


def test_cube_face_st_breaks_ties_as_jax():
    """Directions on cube edges and corners (|x| = |y|, |y| = |z|, all
    equal, signed) and random ones: the same face and (s, t)."""
    r = R(4)
    edges = np.asarray([[a * 1.0, b * 1.0, c * 1.0]
                        for a in (-1, 0, 1) for b in (-1, 0, 1)
                        for c in (-1, 0, 1) if (a, b, c) != (0, 0, 0)],
                       np.float32)
    d = np.concatenate([edges, unit(r, (64, 3))])
    jf, js, jt = jlight._cube_face_st(jnp.asarray(d))
    tf, ts, tt = tlight._cube_face_st(t(d))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    close(ts, js)
    close(tt, jt)


def test_cubemap_pipeline_matches_jax():
    """Mip chain, diffuse irradiance, GGX prefilter, `build_env_mips`,
    `get_mip`, `sample_fg_lut` and `sample_cubemap`."""
    r = R(5)
    cube = r.uniform(0, 2, (6, 32, 32, 3)).astype(np.float32)
    jc, tc = jnp.asarray(cube), t(cube)
    for a, b in zip(tlight.cubemap_mip_chain(tc),
                    jlight.cubemap_mip_chain(jc)):
        close(a, b)
    close(tlight.diffuse_cubemap(tc[:, :16, :16]),
          jlight.diffuse_cubemap(jc[:, :16, :16]), atol=1e-5)
    close(tlight.specular_prefilter(tc, 0.3, 16),
          jlight.specular_prefilter(jc, 0.3, 16), atol=1e-5)
    (ts, td), (js, jd) = tlight.build_env_mips(tc, 16), \
        jlight.build_env_mips(jc, 16)
    assert len(ts) == len(js) == 2
    for a, b in zip(ts + [td], js + [jd]):
        close(a, b, atol=1e-5)
    rough = r.uniform(0, 1, (50,)).astype(np.float32)
    close(tlight.get_mip(t(rough), 5), jlight.get_mip(jnp.asarray(rough), 5))
    ndv = r.uniform(-0.1, 1.1, (50, 1)).astype(np.float32)
    ro = r.uniform(-0.1, 1.1, (50, 1)).astype(np.float32)
    close(tlight.sample_fg_lut(t(ndv), t(ro)),
          jlight.sample_fg_lut(jnp.asarray(ndv), jnp.asarray(ro)))
    d = unit(r, (7, 9, 3))
    close(tlight.sample_cubemap(tc, t(d)),
          jlight.sample_cubemap(jc, jnp.asarray(d)))


@pytest.mark.parametrize("specular", [True, False])
def test_environment_shade_matches_jax(specular):
    """Values, and the gradients to the cubemap, kd and ks within 1e-5 of
    each gradient's largest entry. The normals' gradient is the bilinear
    weights' slope times differences of neighbouring texels of the smooth
    irradiance map (~1e-3 apart, each within ~1e-7 of JAX's after a
    1,536-term sum in another order): 2e-4 of its largest entry."""
    r = R(6)
    cube = r.uniform(0, 2, (6, 16, 16, 3)).astype(np.float32)
    shp = (2, 5, 6)
    pos = r.normal(size=shp + (3,)).astype(np.float32)
    nrm = unit(r, shp + (3,))
    kd = r.uniform(0, 1, shp + (3,)).astype(np.float32)
    ks = np.stack([r.uniform(0, 0.5, shp), r.uniform(0, 1, shp),
                   r.uniform(0, 1, shp)], -1).astype(np.float32)
    view = r.normal(size=(2, 1, 1, 3)).astype(np.float32) * 4
    w = r.normal(size=shp + (3,)).astype(np.float32)

    def jf(cube, kd, ks, nrm):
        return jnp.sum(jlight.environment_shade(
            cube, jnp.asarray(pos), nrm, kd, ks, jnp.asarray(view),
            specular=specular, num_samples=16) * w)
    args = [jnp.asarray(a) for a in (cube, kd, ks, nrm)]
    want = jlight.environment_shade(args[0], jnp.asarray(pos), args[3],
                                    args[1], args[2], jnp.asarray(view),
                                    specular=specular, num_samples=16)
    jgrads = jax.grad(jf, argnums=(0, 1, 2, 3))(*args)
    targs = [t(a).requires_grad_(True) for a in (cube, kd, ks, nrm)]
    got = tlight.environment_shade(targs[0], t(pos), targs[3], targs[1],
                                   targs[2], t(view), specular=specular,
                                   num_samples=16)
    (got * t(w)).sum().backward()
    close(got, want, atol=1e-5)
    for a, g, tol in zip(targs, jgrads, (1e-5, 1e-5, 1e-5, 2e-4)):
        g = np.asarray(g)
        if not np.any(g):
            assert not a.grad.abs().max() > 0
            continue
        close(a.grad, g, atol=tol * np.abs(g).max(), rtol=0)


# ---- the BSDF helpers ----------------------------------------------------

def _bsdf_inputs(seed=7, shp=(4, 5)):
    r = R(seed)
    return dict(
        nrm=unit(r, shp + (3,)), wi=unit(r, shp + (3,)),
        wo=unit(r, shp + (3,)),
        kd=r.uniform(0, 1, shp + (3,)).astype(np.float32),
        arm=r.uniform(0, 1, shp + (3,)).astype(np.float32),
        pos=r.normal(size=shp + (3,)).astype(np.float32),
        view=r.normal(size=shp + (3,)).astype(np.float32) * 3,
        light=r.normal(size=shp + (3,)).astype(np.float32) * 3,
        c=r.uniform(-1, 1, shp + (1,)).astype(np.float32),
        a=r.uniform(0.01, 1, shp + (1,)).astype(np.float32),
        rough=r.uniform(0, 1, shp + (1,)).astype(np.float32))


def test_bsdf_helpers_match_jax():
    x = _bsdf_inputs()
    J = {k: jnp.asarray(v) for k, v in x.items()}
    T = {k: t(v) for k, v in x.items()}
    cases = [
        ("reflect", lambda m, a: m.reflect(a["wo"], a["nrm"])),
        ("lambert", lambda m, a: m.lambert(a["nrm"], a["wi"])),
        ("fresnel_shlick", lambda m, a: m.fresnel_shlick(a["kd"], 1.0,
                                                         a["c"])),
        ("frostbite_diffuse", lambda m, a: m.frostbite_diffuse(
            a["nrm"], a["wi"], a["wo"], a["rough"])),
        ("ndf_ggx", lambda m, a: m.ndf_ggx(a["a"], a["c"])),
        ("lambda_ggx", lambda m, a: m.lambda_ggx(a["a"], a["c"])),
        ("masking_smith", lambda m, a: m.masking_smith(a["a"], a["c"],
                                                       a["rough"])),
        ("pbr_specular", lambda m, a: m.pbr_specular(
            a["kd"], a["nrm"], a["wo"], a["wi"], a["a"])),
        ("pbr_bsdf lambert", lambda m, a: m.pbr_bsdf(
            a["kd"], a["arm"], a["pos"], a["nrm"], a["view"], a["light"])),
        ("pbr_bsdf frostbite", lambda m, a: m.pbr_bsdf(
            a["kd"], a["arm"], a["pos"], a["nrm"], a["view"], a["light"],
            bsdf="frostbite")),
        ("rgb_to_srgb", lambda m, a: m.rgb_to_srgb(a["c"])),
        ("srgb_to_rgb", lambda m, a: m.srgb_to_rgb(a["c"])),
        ("normal map", lambda m, a: m.prepare_shading_normal(
            a["pos"], a["view"], a["nrm"], a["wi"], a["wo"], a["kd"])
            if m is jsh else m.prepare_shading_normal(
                a["pos"], a["view"], a["wi"], a["kd"],
                perturbed_nrm=a["nrm"], smooth_tng=a["wo"])),
    ]
    for name, f in cases:
        want = np.asarray(f(jsh, J))
        assert np.isfinite(want).all() and np.any(want), name
        np.testing.assert_allclose(f(tsh, T).numpy(), want, atol=1e-6,
                                   rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("tonemapper", ["none", "log_srgb"])
@pytest.mark.parametrize("loss", ["l1", "mse", "smape", "relmse"])
def test_image_loss_matches_jax(loss, tonemapper):
    r = R(8)
    img = r.uniform(0, 3, (2, 8, 8, 3)).astype(np.float32)
    tgt = r.uniform(0, 3, (2, 8, 8, 3)).astype(np.float32)
    want = jsh.image_loss(jnp.asarray(img), jnp.asarray(tgt), loss,
                          tonemapper)
    got = tsh.image_loss(t(img), t(tgt), loss, tonemapper)
    close(got, want)
    close(tsh.mse_to_psnr(got), jsh.mse_to_psnr(want))


# ---- render_mesh with the environment light ------------------------------

def antialias_tie_pixels(rast, jrast, v_clip, jv_clip, faces, z_tol=2e-3):
    """(B, H, W) bool: the pixels of the antialias pass's float32 ties
    (`ROADMAP.md` C), which move a pixel by the colour step across its
    pair: pairs that are silhouette pairs on one package's depths and not
    on the other's (their depth gap within 1e-3, the depths' tolerance,
    of the pass's `z_tol`), and pairs at which the blend takes another
    branch on the JAX package's clip-space vertices than on the port's
    (`test_torch_train.blend_branches`)."""
    from animals3d_tpu_torch.ops.antialias import silhouette_pairs
    from animals3d_tpu_torch.ops.rasterize import Rast
    from test_torch_train import blend_branches
    B, H, W = rast.face_id.shape
    jr = Rast(uv=None, z=torch.from_numpy(np.array(jrast.z)),
              face_id=torch.from_numpy(np.array(jrast.face_id)))
    out = np.zeros((B, H * W), bool)
    z = rast.z.reshape(B, -1)
    with torch.no_grad():
        pt = silhouette_pairs(rast, v_clip, faces)
        pj = silhouette_pairs(jr, jv_clip, faces)
        for b in range(B):
            own = {(int(p), int(q)) for p, q, ok in zip(
                pt["p_lin"][b], pt["q_lin"][b], pt["slot_ok"][b]) if ok}
            other = {(int(p), int(q)) for p, q, ok in zip(
                pj["p_lin"][b], pj["q_lin"][b], pj["slot_ok"][b]) if ok}
            for p, q in own ^ other:
                assert abs(abs(float(z[b, p] - z[b, q])) - z_tol) < 1e-3
                out[b, p] = out[b, q] = True
        differ = blend_branches(pt) != blend_branches(
            silhouette_pairs(rast, jv_clip, faces))
    for b, k in torch.nonzero(differ).tolist():
        out[b, int(pt["p_lin"][b, k])] = out[b, int(pt["q_lin"][b, k])] = True
    return out.reshape(B, H, W)


H = 32


def _material(tex_pos, xp):
    """A fixed analytic material of the canonical position: kd in (0, 1),
    ks = (occlusion, roughness, metallic), 9 channels."""
    s = xp.sin(tex_pos * 3.0)
    kd = 0.5 + 0.4 * s
    ks = xp.stack([0.1 + 0.05 * s[..., 0], 0.3 + 0.2 * s[..., 1],
                   0.4 + 0.3 * s[..., 2]], -1)
    return (xp.concatenate if xp is jnp else torch.cat)([kd, ks, kd], -1)


def test_render_mesh_env_light_matches_jax(scene):
    """`shaded`, `kd` and `ks` at 32² with a (6, 16, 16, 3) cubemap made
    by `latlong_to_cubemap` from a seeded 4 × 8 latlong (an environment
    that is smooth across the cube's edges, where the face-clamped
    lookup of both packages is discontinuous): the images as
    `test_torch_render` holds them (atol 1e-4, float64 ties checked), and
    the gradient to the cubemap of a weighted sum of `shaded` over the
    pixels held to 1e-4 within 1e-4 of its largest entry. The pixels of the antialias pass's ties
    (`antialias_tie_pixels`, at most 4) are left out of both: one pair of
    two faces whose depth gap sits at the pass's threshold is seen
    here."""
    from animals3d_tpu.ops import rasterize as jrz
    from animals3d_tpu.render.camera import xfm_points as jxfm
    from animals3d_tpu_torch.ops import rasterize_cuda as rc
    from animals3d_tpu_torch.render.camera import xfm_points as txfm
    from torch_parity import _grow, _silhouette_pairs, assert_images_close
    set_mixed_precision(None)
    jm, jp, tm, prior, mvp, w2c, campos, feat, light, bg = scene
    tprior = _port_mesh(prior)
    with torch.no_grad():
        v_clip = txfm(tprior.v_pos.expand(2, -1, -1), t(mvp))
        rast = rc.rasterize_cuda(v_clip, tprior.t_pos_idx, tprior.f_valid,
                                 (H, H), v_pos0=tprior.v_pos[0])
    jclip = jxfm(jnp.broadcast_to(prior.v_pos, (2, *prior.v_pos.shape[1:])),
                 jnp.asarray(mvp))
    jrast = jrz.rasterize(jclip, prior.t_pos_idx, prior.f_valid, (H, H))
    assert (rast.face_id > 0).sum() > 50
    ties = antialias_tie_pixels(rast, jrast, v_clip, torch.from_numpy(
        np.array(jclip)), tprior.t_pos_idx)
    assert ties.sum() <= 4

    r = R(9)
    cube = np.asarray(jtex.latlong_to_cubemap(
        jnp.asarray(r.uniform(0, 2, (4, 8, 3)).astype(np.float32)), 16))
    wimg = r.normal(size=(2, 4, H, H)).astype(np.float32)
    # the gradient reads the pixels `assert_images_close` holds to 1e-4:
    # off silhouette pairs and away from faces that flip
    fid, jfid = rast.face_id.numpy(), np.asarray(jrast.face_id)
    loose = ties | _grow(fid != jfid) \
        | _silhouette_pairs(fid, rast.z.numpy()) \
        | _silhouette_pairs(jfid, np.asarray(jrast.z))
    wimg[np.broadcast_to(loose[:, None], wimg.shape)] = 0.0
    modes = ["shaded", "kd", "ks"]

    def jrun(cube):
        out = jrender.render_mesh(
            prior, jnp.asarray(mvp), jnp.asarray(w2c), jnp.asarray(campos),
            (H, H), material_fn=lambda p: _material(p, jnp), env_light=cube,
            light_params=jnp.asarray(light),
            background=jnp.asarray(bg[:, :H, :H]), render_modes=modes)
        return jnp.sum(out["shaded"] * wimg), out
    (_l, want), jg = jax.value_and_grad(jrun, has_aux=True)(
        jnp.asarray(cube))
    tc = t(cube).requires_grad_(True)
    got = trender.render_mesh(
        tprior, t(mvp), t(w2c), t(campos), (H, H),
        material_fn=lambda p: _material(p, torch), env_light=tc,
        light_params=t(light), background=t(bg[:, :H, :H]),
        render_modes=modes)
    (got["shaded"] * t(wimg)).sum().backward()
    for key in modes:
        assert got[key].shape == want[key].shape, key
        g_img = got[key].detach().numpy().copy()
        w_img = np.array(want[key])
        g_img[np.broadcast_to(ties[:, None], g_img.shape)] = 0.0
        w_img[np.broadcast_to(ties[:, None], w_img.shape)] = 0.0
        assert_images_close(g_img, w_img, rast, jrast, v_clip,
                            tprior.t_pos_idx)
    g = np.asarray(jg)
    assert np.abs(g).max() > 0 and torch.isfinite(tc.grad).all()
    close(tc.grad, g, atol=1e-4 * np.abs(g).max(), rtol=0)
