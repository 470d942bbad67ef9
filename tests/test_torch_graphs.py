"""netInstance's forward replayed as CUDA graphs (`cuda_graphs`,
`InstancePredictor.forward`).

On the CPU, the eager path that the graphs capture: with its constants made
once per device and its two random draws made first, `forward` gives every
output bit for bit as the benchmark's frozen copy of the port's plain path
(`benchmark/refmodel`) from the same weights, inputs and draws, and runs no
host read and builds no host constant once warm; the cache's choice of
eager, capture or replay over a sequence of keys. On the card (marked
`cuda`, skipped here), in float32 and in the cells' bf16: graph against
eager, outputs and gradients, draws bit for bit, two steps in a row, a
second phase's graph, reconstruction's graph without grad at an odd batch;
one graph for each grad mode, a backward after another replay refused, and
Ponymation's predictor, which stays eager. Imports no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_graphs.py
"""
import os
import sys

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from animals3d_tpu_torch import config as tcfg
from animals3d_tpu_torch import tracing
from animals3d_tpu_torch.geometry.mesh import make_mesh
from animals3d_tpu_torch.models import build_model
from animals3d_tpu_torch.noise import Noise
from animals3d_tpu_torch.phase import Phase
from animals3d_tpu_torch.precision import set_mixed_precision

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "benchmark")
CONFIGS = {"magicpony": "train_magicpony_horse", "fauna": "train_fauna"}
SIZE = 64


def _refmodel():
    if BENCH not in sys.path:
        sys.path.insert(0, BENCH)
    import refmodel.config
    import refmodel.geometry.mesh
    import refmodel.models
    import refmodel.noise
    import refmodel.phase
    import refmodel.precision
    return refmodel


def _cfg(config, name, size=SIZE):
    cfg = config.load_config(name, [f"dataset.in_image_size={size}",
                                    f"dataset.out_image_size={size}"])
    model_cfg = dict(cfg["model"])
    model_cfg["dataset"] = cfg["dataset"]
    return model_cfg


def _prior(rng, make_mesh, V=300, F=400, n_valid=240,
           device="cpu"):
    """A capacity-padded random prior mesh (batch 1): the first `n_valid`
    vertices and their faces valid, the rest zero."""
    verts = np.zeros((V, 3), np.float32)
    verts[:n_valid] = rng.uniform(-0.6, 0.6, (n_valid, 3)) * [0.4, 0.5, 1.0]
    faces = np.zeros((F, 3), np.int64)
    nf = F * 3 // 4
    faces[:nf] = rng.integers(0, n_valid, (nf, 3))
    t = lambda a: torch.as_tensor(a, device=device)
    v_valid = t(np.arange(V) < n_valid)
    f_valid = t(np.arange(F) < nf)
    return make_mesh(t(verts)[None], t(faces), v_valid, f_valid,
                     t(np.int64(n_valid)), t(np.int64(nf)),
                     face_gidx=t(np.arange(F)))


class HostReads(TorchDispatchMode):
    """The operations that read a value on the host or lift a host value
    into a tensor: each a synchronize, or a copy from pageable memory, on
    a CUDA device."""

    def __init__(self):
        super().__init__()
        self.found = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.__name__.split(".")[0] in ("_local_scalar_dense",
                                           "lift_fresh", "lift_fresh_copy"):
            self.found.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def pairs():
    """The port's instance predictor and the reference's, per model, from
    the same weights."""
    ref = _refmodel()
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    set_mixed_precision(None)
    ref.precision.set_mixed_precision(None)
    out = {}
    gen = torch.Generator().manual_seed(0)
    for kind, name in CONFIGS.items():
        port = build_model(_cfg(tcfg, name), device="cpu")
        with torch.no_grad():
            for p in port.netInstance.parameters():
                scale = p.shape[-1] ** -0.5 if p.ndim > 1 else 0.1
                p.uniform_(-scale, scale, generator=gen)
        rm = ref.models.build_model(_cfg(ref.config, name), device="cpu")
        rm.netInstance.load_state_dict(port.netInstance.state_dict())
        out[kind] = (port, rm)
    yield out
    torch.set_num_threads(old)


def _inputs(seed, B=2):
    """Images in [0, 1] and the prior, as the port's and the reference's
    meshes."""
    rng = np.random.default_rng(seed)
    images = torch.from_numpy(rng.uniform(0, 1, (B, 1, 3, SIZE, SIZE))
                              .astype(np.float32))
    mine = _prior(np.random.default_rng(seed), make_mesh)
    theirs = _prior(np.random.default_rng(seed),
                    _refmodel().geometry.mesh.make_mesh)
    return images, mine, theirs


def _leaves(out):
    """The 12-tuple's tensors, by name."""
    names = ("shape", "pose_raw", "pose", "mvp", "w2c", "campos", "feat_out",
             "feat_key", "deformation", "arti_params", "light_params", "aux")
    got = {}
    for n, v in zip(names, out):
        if n == "shape":
            for f in ("v_pos", "v_nrm", "v_tex", "t_pos_idx", "v_valid",
                      "f_valid", "num_verts", "num_faces", "face_gidx"):
                got[f"shape.{f}"] = getattr(v, f)
        elif n == "aux":
            got.update({f"aux.{k}": a for k, a in v.items()})
        else:
            got[n] = v
    return got


PHASE = Phase(deform_on=True, articulation_on=True, attach_legs=True,
              constrain_legs=True, zeroy=True, leg_rot_started=True)


@pytest.mark.parametrize("kind,total_iter,draws", [
    ("magicpony", 3000, "noise"), ("magicpony", 7000, "gen"),
    ("magicpony", 50000, "eval"), ("fauna", 7000, "gen"),
    ("fauna", 100000, "noise")])
def test_eager_forward_matches_the_frozen_plain_path(pairs, kind, total_iter,
                                                     draws):
    """Outputs and `rot_idx` bit for bit, at temperatures, blends and
    p_best that differ, with the draws from a `Noise`, from a generator
    seeded alike, and none (eval)."""
    ref = _refmodel()
    port, rm = pairs[kind]
    images, mine, theirs = _inputs(total_iter)
    N = images.shape[0]
    phase = PHASE._replace(is_training=draws != "eval")
    rng = np.random.default_rng(1)
    ri = torch.from_numpy(rng.integers(0, 4, N))
    bu = torch.from_numpy(rng.uniform(0, 1, N).astype(np.float32))

    def kw(noise_cls):
        if draws == "noise":
            return {"noise": noise_cls(rand_idx=ri, best_u=bu)}
        if draws == "gen":
            return {"gen": torch.Generator().manual_seed(5)}
        return {}
    with torch.no_grad():
        k_ref = kw(ref.noise.Noise)
        want = _leaves(rm.netInstance(images, theirs, total_iter,
                                      ref.phase.Phase(*phase), **k_ref))
        for _ in range(2):          # cold, then with its constants made
            k_port = kw(Noise)
            got = _leaves(port.netInstance(images, mine, total_iter, phase,
                                           **k_port))
            assert set(got) == set(want)
            for k, w in want.items():
                g = got[k]
                assert (g is None) == (w is None), k
                if w is not None:
                    assert g.dtype == w.dtype and torch.equal(g, w), k
            if draws == "gen":
                assert torch.equal(k_port["gen"].get_state(),
                                   k_ref["gen"].get_state())


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_warm_forward_reads_nothing_on_the_host(pairs, kind):
    """Past the hoisted draws and schedules, a warm `forward_drawn` (what a
    CUDA graph captures) neither reads a device value on the host nor lifts
    a host value into a tensor."""
    port, _rm = pairs[kind]
    images, mine, _ = _inputs(11)
    inst = port.netInstance
    N = images.shape[0]
    sched = inst.pose_schedule(20000)
    draws = inst.pose_draws(N, True, "cpu", torch.Generator().manual_seed(2))
    args = (images, mine, sched, PHASE, draws)
    inst.forward_drawn(*args)
    with HostReads() as mode:
        out = inst.forward_drawn(*args)
        out[9].sum().backward()
    assert mode.found == []


def test_rebuilt_outputs_hold_no_reference_cycle(pairs):
    """The graphs rebuild the 12-tuple from their flat outputs
    (`cuda_graphs._flatten` / `_unflatten`): the same tree, and nothing
    that keeps the tensors alive once the caller drops it (a cycle would
    hold each call's outputs until the collector runs)."""
    import gc
    import weakref
    from animals3d_tpu_torch.cuda_graphs import _flatten, _unflatten
    port, _rm = pairs["magicpony"]
    images, mine, _ = _inputs(5)
    with torch.no_grad():
        out = port.netInstance(images, mine, 50000,
                               PHASE._replace(is_training=False))
    leaves = []
    spec = _flatten(out, leaves)
    fresh = [t.clone() for t in leaves]
    alive = [weakref.ref(t) for t in fresh]
    gc.disable()
    try:
        back = _unflatten(spec, fresh)
        got = _leaves(back)
        for k, w in _leaves(out).items():
            assert (got[k] is None) == (w is None), k
            if w is not None:
                assert torch.equal(got[k], w), k
        del fresh, back, got
        assert all(r() is None for r in alive)
    finally:
        gc.enable()


class _StubGraphs:
    """`cuda_graphs._Graphs` without a card: a capture is recorded, a call
    replays."""

    def __init__(self, fn, spec, index, inputs, cache):
        cache.made.append(self)

    def __call__(self, inputs):
        return "replay"


# A run's calls: (key, batch, grad) each, and what each call does. A
# training loop with logging forwards without grad between its steps, which
# run eagerly the first time, then capture and replay beside the step's
# graph; the same with a train and a val batch logged after every step (the
# CLI's `log_image_freq` 1); a phase change replaces the step's graph; an
# evaluation's odd last batch runs eagerly between its full batches'
# replays.
POLICY = {
    "train_and_log": ([("A", 4, True)] * 3 + [("L", 2, False), ("A", 4, True),
                       ("L", 2, False), ("L", 2, False), ("A", 4, True)],
                      "ecrercrr"),
    "log_every_step": ([("A", 4, True)] + [("L", 4, False)] * 2
                       + [("A", 4, True)] + [("L", 4, False)] * 2
                       + [("A", 4, True)] * 2, "eeccrrrr"),
    "phase_change": ([("A", 4, True)] * 2 + [("C", 4, True)] * 3
                     + [("A", 4, True)] * 2, "ececrec"),
    "recon_odd_batch": ([("R", 4, False)] * 3 + [("R", 3, False)]
                        + [("R", 4, False)] * 2, "ecrerr"),
}


@pytest.mark.parametrize("case", sorted(POLICY))
def test_graph_cache_keeps_one_graph_per_grad_mode(monkeypatch, case):
    """`GraphCache`: eager (e) unless the key is the held graph's of its
    grad mode (r, replay) or that of the call before in its grad mode (c,
    capture); the counters follow."""
    from animals3d_tpu_torch import cuda_graphs
    monkeypatch.setattr(cuda_graphs, "_Graphs", _StubGraphs)
    cache = cuda_graphs.GraphCache("stub", torch.nn.Linear(2, 2))
    cache.made = []
    calls, want = POLICY[case]
    got = ""
    tracing.enable()
    try:
        for key, batch, grad in calls:
            made = len(cache.made)
            with torch.set_grad_enabled(grad):
                out = cache(key, None, (torch.zeros(batch, 3),))
            got += "e" if out is None else "c" if len(cache.made) > made \
                else "r"
        counters = tracing.snapshot()["counters"]
    finally:
        tracing.disable()
    assert got == want
    assert counters.get("stub.graph_captures", 0) == want.count("c")
    assert counters.get("stub.graph_replays", 0) == want.count("r")
    assert len(cache.graphs) <= 2


@pytest.mark.parametrize("change", ["moved", "anomaly"])
def test_graph_cache_forgets_moved_parameters_and_skips_anomaly(monkeypatch,
                                                              change):
    """A parameter that moves drops the graphs (the next call is eager,
    the one after captures again); under anomaly detection every call runs
    eagerly."""
    from animals3d_tpu_torch import cuda_graphs
    monkeypatch.setattr(cuda_graphs, "_Graphs", _StubGraphs)
    module = torch.nn.Linear(2, 2)
    cache = cuda_graphs.GraphCache("stub", module)
    cache.made = []
    x = (torch.zeros(3, 2),)
    assert [cache("A", None, x) for _ in range(3)] == [None, "replay",
                                                       "replay"]
    if change == "moved":
        module.weight.data = module.weight.data.clone()
        assert [cache("A", None, x) for _ in range(3)] == [None, "replay",
                                                           "replay"]
        assert len(cache.made) == 2
    else:
        with torch.autograd.set_detect_anomaly(True):
            assert [cache("A", None, x) for _ in range(3)] == [None] * 3
        assert len(cache.made) == 1


# ----------------------------------------------------------------------
# On the card: graph against eager

CARD_B = 2
CARD_IT = 50000


@pytest.fixture(scope="module")
def card():
    """MagicPony at its training shapes (256², grid 128, its v_cap and
    f_cap) with a small batch, TF32 off, and the prior its random-weight
    netBase extracts in float32."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs have no CPU mode")
    set_mixed_precision(None)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = build_model(_cfg(tcfg, "train_magicpony_horse", 256),
                        device="cuda")
    model.init_params(0)
    phase = model.phase_for_iter(CARD_IT)
    grid, v_cap, f_cap = model.grid_for_phase(phase)
    with torch.no_grad():
        prior, _sdf, _, _ = model.forward_base(
            grid, v_cap, f_cap, jitter=torch.full((), 0.3, device="cuda"))
    yield model, prior, phase
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = tf32


def _leaf_prior(prior):
    """The prior with a fresh leaf `v_pos` (and `v_tex`, the same tensor)
    whose gradient the step reads."""
    v_pos = prior.v_pos.detach().clone().requires_grad_(True)
    return make_mesh(v_pos, prior.t_pos_idx, prior.v_valid, prior.f_valid,
                     prior.num_verts, prior.num_faces,
                     face_gidx=prior.face_gidx)


def _images(seed, B):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.rand((B, 1, 3, 256, 256), generator=g, device="cuda")


def _cotangents(leaves):
    """Fixed random weights of each differentiable output: the loss is
    their dot product with the outputs."""
    g = torch.Generator(device="cuda").manual_seed(7)
    return {k: torch.randn(t.shape, generator=g, device="cuda")
            for k, t in leaves.items()
            if t is not None and t.requires_grad}


def _eager(inst, images, prior, it, phase, gen=None, noise=None):
    """`inst`'s forward as it runs without graphs: the draws, then the
    rest eagerly."""
    random_sample = phase.is_training and inst.cfg.cfg_pose.rand_campos
    draws = inst.pose_draws(images.shape[0] * images.shape[1],
                            random_sample, images.device, gen, noise)
    return inst.forward_drawn(images, prior, inst.pose_schedule(it), phase,
                              draws, gen=gen, noise=noise)


def _step(inst, images, prior, it, phase, seed=None, noise=None, w=None,
          eager=False):
    """One forward (graphed, or `eager`) and backward: (outputs, gradients
    of the parameters and of the prior's vertices, the generator's state
    after, the weights)."""
    prior = _leaf_prior(prior)
    gen = None if seed is None else \
        torch.Generator(device="cuda").manual_seed(seed)
    fwd = (lambda *a, **k: _eager(inst, *a, **k)) if eager else inst
    leaves = _leaves(fwd(images, prior, it, phase, gen=gen, noise=noise))
    w = w or _cotangents(leaves)
    loss = sum((leaves[k] * c).sum() for k, c in w.items())
    loss.backward()
    grads = {n: p.grad for n, p in inst.named_parameters()
             if p.grad is not None}
    grads["prior.v_pos"] = prior.v_pos.grad
    inst.zero_grad(set_to_none=True)
    return leaves, grads, None if gen is None else gen.get_state(), w


@pytest.fixture(params=[None, "bf16"], ids=["float32", "bf16"])
def precision(request):
    """The precision policy: float32, and the cells' bf16."""
    set_mixed_precision(request.param)
    yield request.param
    set_mixed_precision(None)


# Floats within this share of the reference's norm. Two eager steps differ
# too: the atomics of index_add, and cuDNN's weight gradients of the heads'
# convolutions, order their sums differently from call to call. On the H100
# two eager steps on the same inputs differed by up to 3.3e-5 of a norm in
# float32 (graph against eager 3.2e-5) and by up to 3.9e-3 in bf16, where a
# sum that rounds the other way moves a value by a bf16 ulp (graph against
# eager 5.1e-3, netEncoder's key head); each tolerance is three times the
# eager steps' spread.
TOL = {None: 1e-4, "bf16": 1.2e-2}


def _close(got, want, what, tol=TOL[None]):
    """Integers equal; floats within `tol` of the reference's norm."""
    assert set(got) == set(want), what
    for k, w in want.items():
        g = got[k]
        assert (g is None) == (w is None), (what, k)
        if w is None:
            continue
        assert g.shape == w.shape and g.dtype == w.dtype, (what, k)
        if not w.is_floating_point():
            assert torch.equal(g, w), (what, k)
        else:
            gap = (g.double() - w.double()).norm()
            assert gap <= tol * w.double().norm() + 1e-6, (what, k, gap)


def _snap(d):
    return {k: None if v is None else v.detach().clone()
            for k, v in d.items()}


def _counts():
    c = tracing.snapshot()["counters"]
    return tuple(c.get("netinstance." + n, 0) for n in
                 ("graph_captures", "graph_replays", "eager_calls"))


@pytest.mark.cuda
def test_graphs_match_eager_forward_and_backward(card, precision):
    """At two iterations whose temperature, blend and p_best differ, with
    the draws from a seeded generator and from a `Noise`: the graphed
    steps' outputs, parameter gradients and prior-vertex gradients match
    the eager step's, the draws and the generator's state bit for bit;
    two graphed steps in a row leave the first's outputs and `.grad`s as
    they were; a phase change captures a second graph."""
    model, prior, phase = card
    tol = TOL[precision]
    inst = model.netInstance
    N = CARD_B
    noise = Noise(rand_idx=torch.tensor([3, 1]),
                  best_u=torch.tensor([0.9, 0.1]))
    tracing.enable()
    try:
        for it in (3000, 7000):
            for draws in ("gen", "noise"):
                kw = {"seed": 11} if draws == "gen" else {"noise": noise}
                images = [_images(s, N) for s in (1, 2)]
                want = [_step(inst, im, prior, it, phase, **kw, eager=True)
                        for im in images]
                before = _counts()
                _step(inst, images[0], prior, it, phase, **kw,
                      w=want[0][3])                    # warm (or replay)
                got = [_step(inst, im, prior, it, phase, **kw, w=want[i][3])
                       for i, im in enumerate(images)]
                for (gl, gg, gs, _), (wl, wg, ws, _) in zip(got, want):
                    _close(gl, wl, f"outputs at {it}, {draws}", tol)
                    _close(gg, wg, f"gradients at {it}, {draws}", tol)
                    assert torch.equal(gl["aux.rot_idx"], wl["aux.rot_idx"])
                    assert torch.equal(gl["aux.rand_pose_flag"],
                                       wl["aux.rand_pose_flag"])
                    if gs is not None:
                        assert torch.equal(gs, ws)
                # the first graphed step's outputs and `.grad`s, held past
                # the second step, are as the eager step's
                _close(got[0][0], want[0][0], "held outputs", tol)
                _close(got[0][1], want[0][1], "held gradients", tol)
                captures, replays, eager = (a - b for a, b in
                                            zip(_counts(), before))
                assert eager == 0 or (it, draws) == (3000, "gen")
                assert captures + replays + eager == 3
        # one key so far: phase, draws and shapes did not change
        assert _counts()[0] == 1
        other = phase._replace(deform_on=not phase.deform_on)
        for _ in range(3):
            _step(inst, _images(3, N), prior, 7000, other, seed=1)
        assert _counts()[0] == 2
    finally:
        tracing.disable()


@pytest.mark.cuda
@pytest.mark.parametrize("B", [3])
def test_reconstruct_graph_without_grad_at_an_odd_batch(card, precision, B):
    """`reconstruct`'s forward: grad off, no draws, an odd batch; the
    graph's outputs match eager, stay as they were past the next call, and
    a replay neither synchronizes nor copies from the host."""
    model, prior, _ = card
    inst = model.netInstance
    phase = model.phase_for_iter(CARD_IT, is_training=False)
    images = [_images(s, B) for s in (4, 5)]
    with torch.no_grad():
        want = [_snap(_leaves(_eager(inst, im, prior, CARD_IT, phase)))
                for im in images]
        inst(images[0], prior, CARD_IT, phase)          # warm
        inst(images[0], prior, CARD_IT, phase)          # capture
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = [_leaves(inst(im, prior, CARD_IT, phase)) for im in images]
        finally:
            torch.cuda.set_sync_debug_mode(0)
    for g, w in zip(got, want):
        _close(g, w, "reconstruction outputs", TOL[precision])
    assert not any(t.requires_grad for t in got[0].values()
                   if t is not None)


@pytest.mark.cuda
def test_one_graph_per_grad_mode_and_a_late_backward_raises(card):
    """A no-grad call between training steps runs eagerly and leaves the
    step's graph; at its key's next call it captures beside it, in the same
    pool, and the step still replays. A backward after another replay of
    the cache would read memory that replay overwrote: it raises."""
    model, prior, phase = card
    inst = model.netInstance
    evaluation = phase._replace(is_training=False)
    tracing.enable()
    try:
        for _ in range(2):
            _step(inst, _images(1, CARD_B), prior, 7000, phase, seed=3)
        before = _counts()
        for want in ((0, 1, 1), (1, 2, 1), (1, 4, 1)):   # e r, c r, r r
            with torch.no_grad():
                inst(_images(2, 5), prior, 7000, evaluation)
            _step(inst, _images(1, CARD_B), prior, 7000, phase, seed=3)
            assert tuple(a - b for a, b in zip(_counts(), before)) == want
        assert len(inst._graphs.graphs) == 2
        gen = torch.Generator(device="cuda").manual_seed(3)
        first = inst(_images(1, CARD_B), _leaf_prior(prior), 7000, phase,
                     gen=gen)
        inst(_images(2, CARD_B), _leaf_prior(prior), 7000, phase, gen=gen)
        with pytest.raises(RuntimeError, match="replayed between"):
            first[9].sum().backward()
        inst.zero_grad(set_to_none=True)
    finally:
        tracing.disable()


@pytest.mark.cuda
def test_ponymation_stays_eager(card):
    """A predictor that draws inside its forward (Ponymation's VAE) runs
    eagerly, counted as such (the CPU's eager calls: `test_torch_tracing`
    `test_train_step_and_reconstruct_give_the_layer_tree`)."""
    from animals3d_tpu_torch.predictors.motion_vae import MotionVAEPredictor
    assert MotionVAEPredictor.draws_in_forward
    pony = build_model(_cfg(tcfg, "train_ponymation_horse_stage2", 256),
                       device="cuda")
    assert pony.netInstance.draws_in_forward
    _, prior, _ = card
    phase = pony.phase_for_iter(CARD_IT)
    gen = torch.Generator(device="cuda").manual_seed(0)
    frames = pony.num_frames
    images = torch.rand((1, frames, 3, 256, 256), device="cuda")
    tracing.enable()
    try:
        before = _counts()
        with torch.no_grad():
            for _ in range(3):
                pony.netInstance(images, prior, CARD_IT, phase, gen=gen)
        assert tuple(a - b for a, b in zip(_counts(), before)) == (0, 0, 3)
    finally:
        tracing.disable()
