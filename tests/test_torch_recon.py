"""The port's single-image reconstruction slice against the JAX package:
`reconstruct` (netBase → netInstance → render ["shaded"]) on the chain of
`bench.py:230-245`, at a small size, with the JAX init weights carried
across. Also the weight bridge and the port's import boundary."""
import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animals3d_tpu.ops import rasterize as jrz
from animals3d_tpu.render.camera import xfm_points as jxfm
from animals3d_tpu_torch.ops import rasterize_cuda as rc
from animals3d_tpu_torch.precision import set_mixed_precision
from animals3d_tpu_torch.render.camera import xfm_points as txfm
from torch_parity import (assert_images_close, build_pair, numpy_tree,
                          to_np)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H = 64


@pytest.fixture(scope="module")
def pair():
    set_mixed_precision(None)
    return build_pair()


def _jax_recon(jm, jp, images, it):
    """The recon chain of `bench.py:230-245`, jitted."""
    phase = jm.phase_for_iter(it)
    grid, v_cap, f_cap = jm.grid_for_phase(phase)

    def chain(params, images):
        prior, _ = jm.netBase.apply({"params": params["netBase"]}, grid,
                                    v_cap, f_cap, it, None)
        out = jm.netInstance.apply(
            {"params": params["netInstance"]}, images, prior, it,
            jax.random.PRNGKey(1), phase._replace(is_training=False))
        shape, mvp = out[0], out[3]
        renders = jm.render(params, ["shaded"], shape, mvp, out[4], out[5],
                            (H, H), im_features=out[6],
                            light_params=out[10], prior_mesh=prior,
                            num_frames=1)
        rast = jrz.rasterize(jxfm(shape.v_pos, mvp), shape.t_pos_idx,
                             shape.f_valid, (H, H))
        return renders["shaded"], out, rast
    return jax.jit(chain)(jp, jnp.asarray(images))


@pytest.mark.parametrize("it", [50000, 95000])
def test_reconstruct_matches_jax_chain(pair, it):
    """Phase 50000 (articulation on, deform off) and 95000 (deform on too).
    mvp, articulation and light within 1e-4; the posed vertices within
    1e-4; shaded RGBA per `assert_images_close`: 1e-4, away from the faces
    flipped by rounding (each a float64 tie; at most 0.2% of the pixels,
    where up to 7 of 8,192 are seen), and 4e-3 on antialiased silhouette
    pairs. After the ViT and the skinning the two packages' vertices
    differ by ~1e-5, and by an amount that depends on the CPU thread
    count (1 to 8 threads tried). That moves the depth of a sub-pixel face
    by up to 1.93e-3 (phase 95000), hence z within 3e-3, and a silhouette
    edge nearly parallel to a pixel pair amplifies it in its blend weight,
    up to 2.4e-3 (phase 95000)."""
    set_mixed_precision(None)
    jm, jp, tm = pair
    phase = jm.phase_for_iter(it)
    assert phase.articulation_on and phase.deform_on == (it > 90000)
    images = np.random.default_rng(it).uniform(
        0, 1, (2, 1, 3, H, H)).astype(np.float32)
    want, wout, wrast = _jax_recon(jm, jp, images, it)

    launches = rc.visibility.launches
    shaded, out = tm.reconstruct(tm, torch.from_numpy(images), it)
    assert rc.visibility.launches == launches      # the CPU path launches none
    assert len(out) == 12 and shaded.shape == (2, 4, H, H)
    assert (out[8] is not None) == phase.deform_on
    for name, i in (("mvp", 3), ("arti_params", 9), ("light_params", 10)):
        np.testing.assert_allclose(to_np(out[i]), np.asarray(wout[i]),
                                   atol=1e-4, rtol=0, err_msg=name)
    np.testing.assert_allclose(to_np(out[0].v_pos), np.asarray(wout[0].v_pos),
                               atol=1e-4, rtol=0)
    shape = out[0]
    with torch.no_grad():
        v_clip = txfm(shape.v_pos, out[3])
        rast = rc.rasterize_cuda(v_clip, shape.t_pos_idx, shape.f_valid,
                                 (H, H), v_pos0=shape.v_pos[0])
    assert (to_np(rast.face_id) > 0).sum() > 100   # the animal is in view
    assert_images_close(shaded, want, rast, wrast, v_clip, shape.t_pos_idx,
                        silhouette_atol=4e-3, z_atol=3e-3, max_share=0.002)


def _to_flax_layout(name, value):
    """Inverse of `load_jax_params`'s layout change for one tensor."""
    v = value.detach().numpy()
    if name.endswith("weight") and v.ndim == 2:
        return v.T
    if name.endswith("weight") and v.ndim == 4:
        return v.transpose(2, 3, 1, 0)
    return v


def test_load_jax_params_round_trip(pair):
    """Every leaf of the whole MagicPony tree lands on one port parameter
    and comes back bit for bit; a missing or extra leaf raises."""
    from animals3d_tpu_torch.convert_jax import load_jax_params
    jm, jp, tm = pair
    tree = numpy_tree(jp)
    params = dict(tm.named_parameters())
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(leaves) == len(params)
    for path, leaf in leaves:
        keys = [p.key for p in path]
        *mods, last = keys
        name = ".".join(mods + ["weight" if last in ("kernel", "scale")
                                else last])
        np.testing.assert_array_equal(_to_flax_layout(name, params[name]),
                                      leaf, err_msg=name)
    broken = jax.tree_util.tree_map(lambda x: x, tree)
    broken["netBase"]["netSDF"].pop("in_layer")
    with pytest.raises(KeyError):
        load_jax_params(tm, broken)
    extra = jax.tree_util.tree_map(lambda x: x, tree)
    extra["netBase"]["stray"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError):
        load_jax_params(tm, extra)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax():
    """No file of the port, nor chip_smoke.py, the profile script or the
    card-only tests, imports jax, flax, optax, orbax or the JAX package.
    The training slice's modules, the loop's, the loaders', the
    checkpoints', the CLI's, Fauna's and Ponymation's, the Visualizer's,
    the evaluation's and the logging's are among the files scanned."""
    files = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "scripts", "torch_recon_profile.py"),
             os.path.join(REPO, "tests", "test_torch_cuda.py")]
    for root, _dirs, names in os.walk(os.path.join(REPO,
                                                   "animals3d_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    scanned = {os.path.relpath(f, REPO) for f in files}
    for new in ("ops/fused_mlp.py", "ops/resolve_cuda.py", "trainer.py",
                "noise.py", "data/synth.py", "models/animal.py", "run.py",
                "checkpoint.py", "data/loaders.py", "native.py",
                "utils/results_io.py", "models/fauna.py",
                "predictors/bank.py", "predictors/fauna.py",
                "networks/discriminator.py", "data/fauna_dataset.py",
                "models/ponymation.py", "predictors/motion_vae.py",
                "networks/motion_vae.py", "data/sequence_dataset.py",
                "utils/smooth_loss.py", "visualization.py", "evaluation.py",
                "utils/visual_log.py", "utils/wandb_writer.py"):
        assert os.path.join("animals3d_tpu_torch", new) in scanned, new
    banned = ("jax", "flax", "optax", "orbax", "animals3d_tpu")
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in banned, f"{path} imports {mod}"
