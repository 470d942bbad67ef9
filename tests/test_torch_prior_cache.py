"""netBase's held eval prior (`BasePredictor.get_prior_mesh`): with no
jitter, no condition and grad off a second call returns the first call's
(mesh, sdf), bit for bit what a fresh predictor computes; every change of
what the prior is a function of makes the next call compute it afresh;
jitter, a condition or grad bypass the held pair; and `reconstruct` writes
nothing into it. On the CPU, at small lattices."""
import dataclasses
import os
import tempfile

import pytest
import torch

from animals3d_tpu_torch import config as cfglib
from animals3d_tpu_torch import parallel, tracing
from animals3d_tpu_torch.data.synth import fake_batch
from animals3d_tpu_torch.geometry import tets as ttets
from animals3d_tpu_torch.models import build_model
from animals3d_tpu_torch.precision import set_mixed_precision
from animals3d_tpu_torch.predictors import base as tbase
from animals3d_tpu_torch.predictors import config as tconf

COUNTERS = ("netbase.prior_hits", "netbase.prior_misses",
            "netbase.prior_bypass")
# the dense eval sweep at grid 12; the banded sweep (an even lattice of 64
# or more) at grid 64 with a narrower net
SWEEPS = {"dense": dict(grid_res=12, hidden_size=256),
          "banded": dict(grid_res=64, hidden_size=32,
                         sparse_band_eval=True)}


@pytest.fixture(autouse=True)
def _numerics():
    """float32, TF32 as it was, tracing on for the counters, and one
    thread: at several, the CPU's matmuls may split a sum differently
    from one call to the next, and a fresh sweep would then differ from
    the held one by an ulp."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    set_mixed_precision(None)
    tracing.disable()
    tracing.enable()
    yield
    tracing.disable()
    set_mixed_precision(None)
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = tf32
    torch.set_num_threads(threads)


def _counts():
    c = tracing.snapshot()["counters"]
    return tuple(c.get(n, 0) for n in COUNTERS)


def _predictor(sweep="dense", condition_choice=None, seed=0):
    kw = dict(spatial_scale=7.0, num_layers=5, embedder_freq=8,
              init_sdf="ellipsoid", jitter_grid=0.05, symmetrize=True,
              **SWEEPS[sweep])
    mod = tbase.BasePredictor(tconf.BasePredictorConfig(
        cfg_shape=tconf.ShapeConfig(**kw),
        cfg_dino=tconf.DINOConfig(feature_dim=4, num_layers=2,
                                  hidden_size=32)),
        condition_choice=condition_choice)
    gen = torch.Generator().manual_seed(seed)
    for m in mod.modules():
        if hasattr(m, "init_weights"):
            m.init_weights(gen)
    return mod


def _grid(res):
    return ttets.DeviceTetGrid(ttets.load_tet_grid(res), "cpu")


def _caps(res):
    return ttets.default_capacity(res)


def _tensors(pair):
    """The tensors of a (mesh, sdf) pair, by name."""
    mesh, sdf = pair
    out = {f.name: getattr(mesh, f.name) for f in dataclasses.fields(mesh)
           if getattr(mesh, f.name) is not None}
    out["sdf"] = sdf
    return out


def _assert_same_bits(got, want):
    got, want = _tensors(got), _tensors(want)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k].detach(), want[k].detach()), k


def _fresh(mod, grid, v_cap, f_cap, mode=torch.no_grad, **kw):
    """What a new predictor with `mod`'s config and weights computes."""
    other = _predictor(mod.cfg.cfg_shape.sparse_band_eval and "banded"
                       or "dense", mod.condition_choice, seed=1)
    other.cfg = mod.cfg
    other.load_state_dict(mod.state_dict())
    with mode():
        return other.get_prior_mesh(grid, v_cap, f_cap, **kw)


@pytest.mark.parametrize("sweep", sorted(SWEEPS))
def test_second_eval_call_returns_the_held_prior(sweep):
    """The second call returns the first call's tensors themselves, equal
    bit for bit to a fresh predictor's, and counts one miss then one hit;
    a bypassing call between them leaves the held pair in place."""
    mod = _predictor(sweep)
    res = SWEEPS[sweep]["grid_res"]
    grid, (v_cap, f_cap) = _grid(res), _caps(res)
    assert mod._use_band(grid) == (sweep == "banded")
    with torch.no_grad():
        first = mod.get_prior_mesh(grid, v_cap, f_cap)
    assert _counts() == (0, 1, 0)
    assert int(first[0].num_faces) > 0
    mod.get_prior_mesh(grid, v_cap, f_cap)              # grad on: bypass
    assert _counts() == (0, 1, 1)
    with torch.no_grad():
        second = mod.get_prior_mesh(grid, v_cap, f_cap)
    assert _counts() == (1, 1, 1)
    for k, t in _tensors(second).items():
        assert t is _tensors(first)[k], k
    _assert_same_bits(second, _fresh(mod, grid, v_cap, f_cap))


def _adam_step(mod, call):
    opt = torch.optim.Adam(mod.parameters(), lr=1e-3, foreach=True)
    pts = torch.linspace(-3, 3, 30).reshape(10, 3)
    mod.get_sdf(pts).square().sum().backward()
    opt.step()
    return call


def _copy(mod, call):
    with torch.no_grad():
        mod.netSDF.in_layer.weight.copy_(mod.netSDF.in_layer.weight * 1.01)
    return call


def _load_state_dict(mod, call, assign=False):
    state = {k: v * 1.01 if v.is_floating_point() else v.clone()
             for k, v in mod.state_dict().items()}
    mod.load_state_dict(state, assign=assign)
    return call


def _param_data(mod, call):
    w = mod.netSDF.in_layer.weight
    w.data = w.data * 1.01
    return call


def _to(mod, call):
    """A round trip through float64: the same values in new tensors under
    the same parameter objects."""
    mod.to(torch.float64).to(torch.float32)
    return call


def _broadcast(mod, call):
    """Rank 0's weights broadcast over a gloo group of one: written
    through `.data`, which moves no version of itself."""
    with tempfile.TemporaryDirectory() as tmp:
        parallel.init_distributed("cpu", store=os.path.join(tmp, "store"),
                                  rank=0, world_size=1)
        try:
            parallel.broadcast_params(mod)
        finally:
            parallel.shutdown()
    return call


def _precision(mod, call):
    set_mixed_precision("bf16")
    return call


def _tf32(mod, call):
    torch.backends.cuda.matmul.allow_tf32 = \
        not torch.backends.cuda.matmul.allow_tf32
    return call


def _new_grid(mod, call):
    return dict(call, grid=_grid(12))


def _other_res(mod, call):
    v_cap, f_cap = _caps(10)
    return dict(call, grid=_grid(10), v_cap=v_cap, f_cap=f_cap)


def _v_cap(mod, call):
    return dict(call, v_cap=call["v_cap"] // 2)


def _f_cap(mod, call):
    return dict(call, f_cap=call["f_cap"] // 2)


def _config(mod, call):
    mod.cfg = dataclasses.replace(mod.cfg, cfg_shape=dataclasses.replace(
        mod.cfg.cfg_shape, spatial_scale=6.5))
    return call


CHANGES = {"adam_step": _adam_step, "copy_": _copy,
           "load_state_dict": _load_state_dict,
           "load_state_dict_assign":
               lambda m, c: _load_state_dict(m, c, assign=True),
           "param_data": _param_data, "to": _to, "broadcast": _broadcast,
           "precision": _precision, "tf32": _tf32, "new_grid": _new_grid,
           "grid_res": _other_res,
           "v_cap": _v_cap, "f_cap": _f_cap, "config": _config,
           "inference_mode": lambda m, c: dict(c, inference=True)}


@pytest.mark.parametrize("change", sorted(CHANGES))
def test_a_change_recomputes_the_prior(change):
    """After each change of what the prior is a function of, the next
    eval call misses, returns new tensors and equals a fresh predictor's
    computation under the change."""
    mod = _predictor()
    call = dict(grid=_grid(12), v_cap=_caps(12)[0], f_cap=_caps(12)[1])
    with torch.no_grad():
        first = mod.get_prior_mesh(call["grid"], call["v_cap"],
                                   call["f_cap"])
    call = CHANGES[change](mod, call)
    args = (call["grid"], call["v_cap"], call["f_cap"])
    mode = torch.inference_mode if call.get("inference") else torch.no_grad
    with mode():
        second = mod.get_prior_mesh(*args)
    assert _counts() == (0, 2, 0)
    assert second[1] is not first[1] and second[0] is not first[0]
    _assert_same_bits(second, _fresh(mod, *args, mode=mode))
    with mode():
        third = mod.get_prior_mesh(*args)
    assert third[1] is second[1]
    assert _counts()[0] == 1


def _feats():
    return torch.linspace(-1, 1, 128)[None]


def _inference_grid(res):
    with torch.inference_mode():
        return _grid(res)


# (condition, keywords, grad mode, grid)
BYPASS = {"jitter": (None, dict(jitter=torch.tensor(0.3)), torch.no_grad,
                     _grid),
          "grad": (None, {}, torch.enable_grad, _grid),
          "feats": ("mod", dict(feats=_feats()), torch.no_grad, _grid),
          "inference_grid": (None, {}, torch.no_grad, _inference_grid)}


@pytest.mark.parametrize("case", sorted(BYPASS))
def test_jitter_grad_condition_or_inference_input_bypass(case):
    """Calls with jitter, grad on, a condition, or a lattice made in
    inference mode (its positions have no version) count a bypass each,
    never a hit, return new tensors each time, and compute what a fresh
    predictor does (with grad, a graph back to the weights)."""
    condition, kw, mode, make_grid = BYPASS[case]
    mod = _predictor(condition_choice=condition)
    grid, (v_cap, f_cap) = make_grid(12), _caps(12)
    with mode():
        a = mod.get_prior_mesh(grid, v_cap, f_cap, **kw)
        b = mod.get_prior_mesh(grid, v_cap, f_cap, **kw)
    assert _counts() == (0, 0, 2)
    assert a[1] is not b[1] and mod._held_prior is None
    assert b[1].requires_grad == (case == "grad")
    want = _fresh(mod, grid, v_cap, f_cap, mode=mode, **kw)
    _assert_same_bits(b, want)


TINY = ["dataset.in_image_size=64", "dataset.out_image_size=64",
        "model.cfg_predictor_base.cfg_shape.grid_res=8",
        "model.cfg_predictor_base.cfg_shape.grid_res_coarse=8",
        "model.cfg_predictor_base.cfg_shape.num_layers=2",
        "model.cfg_predictor_base.cfg_shape.hidden_size=32",
        "model.cfg_predictor_base.cfg_dino.num_layers=2",
        "model.cfg_predictor_base.cfg_dino.hidden_size=32",
        "model.cfg_predictor_base.cfg_dino.feature_dim=4",
        "model.cfg_predictor_instance.cfg_encoder.cout=32",
        "model.cfg_predictor_instance.cfg_texture.num_layers=2",
        "model.cfg_predictor_instance.cfg_texture.hidden_size=32",
        "model.cfg_predictor_instance.cfg_deform.num_layers=2",
        "model.cfg_predictor_instance.cfg_deform.hidden_size=32",
        "model.cfg_predictor_instance.cfg_articulation.num_layers=1",
        "model.cfg_predictor_instance.cfg_articulation.hidden_size=32",
        "model.cfg_predictor_instance.cfg_light.num_layers=2",
        "model.cfg_predictor_instance.cfg_light.hidden_size=32",
        "dataset.dino_feature_dim=4"]


def test_reconstruct_writes_nothing_into_the_held_prior():
    """Two tiny-config `reconstruct` calls (deformation and articulation
    on) hit the prior held from an eval `forward_base`, give the same
    RGBA, and leave every tensor of the held pair at its version and its
    bits."""
    cfg = cfglib.load_config("train_magicpony_horse", overrides=TINY)
    model = build_model(dict(cfg["model"], dataset=cfg["dataset"]),
                        device="cpu")
    model.init_params(0)
    it = 140000
    phase = model.phase_for_iter(it, is_training=False)
    assert phase.deform_on and phase.articulation_on
    grid, v_cap, f_cap = model.grid_for_phase(phase)
    with torch.no_grad():
        held = model.forward_base(grid, v_cap, f_cap)[:2]
    tensors = _tensors(held)
    versions = {k: t._version for k, t in tensors.items()}
    bits = {k: t.clone() for k, t in tensors.items()}
    images = fake_batch(model, 2)["images"]
    rgba1, _ = model.reconstruct(model, images, it)
    rgba2, _ = model.reconstruct(model, images, it)
    assert _counts() == (2, 1, 0)
    assert model.netBase._held_prior[3][1] is held[1]
    assert torch.equal(rgba1, rgba2)
    for k, t in tensors.items():
        assert t._version == versions[k], k
        assert torch.equal(t, bits[k]), k
