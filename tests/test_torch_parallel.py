"""The port's data parallelism (`animals3d_tpu_torch.parallel`) on the
CPU with gloo: the host-strided loaders against the JAX `Loader`, the
training step on two ranks against one rank on the same global batch and
random draws (the check of `__graft_entry__.dryrun_multichip`), and the
`Trainer` on two ranks.

The ranks are child processes of this file (`python
tests/test_torch_parallel.py ROLE ...`), started with
`OMP_WAIT_POLICY=PASSIVE` and one torch thread as `tests/torch_search.py`
starts its child, joined through a `FileStore` in a temporary directory,
and killed at `SPAWN_TIMEOUT`. They import no JAX: the parent hands them
the overrides and the batch in a `torch.save` file.
"""
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
SPAWN_TIMEOUT = 240      # seconds a spawning test may take before it fails
WORLD = 2
DP_IT = 95000            # deform and articulation on, as dryrun_multichip
DP_BATCH = 4             # the global batch of the two-rank step
DP_SEED = 0              # the seed of its random draws


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def spawn(role, args, world=WORLD):
    """Run `role` of this file on `world` ranks; returns rank 0's
    `torch.save`d result. A rank that fails or outlives `SPAWN_TIMEOUT`
    fails the test (every rank is killed)."""
    env = dict(os.environ, OMP_WAIT_POLICY="PASSIVE", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [TESTS, REPO, os.environ.get("PYTHONPATH", "")]))
    with tempfile.TemporaryDirectory() as tmp:
        store, out = os.path.join(tmp, "store"), os.path.join(tmp, "out.pt")
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), role, store,
             str(r), str(world), out, *args], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=SPAWN_TIMEOUT)[0])
        except subprocess.TimeoutExpired:
            pytest.fail(f"{role}: a rank ran past {SPAWN_TIMEOUT} s")
        finally:
            for p in procs:
                p.kill()
        for r, (p, log) in enumerate(zip(procs, logs)):
            assert p.returncode == 0, f"{role} rank {r}:\n{log[-4000:]}"
        return torch.load(out, weights_only=False)


# ---------------------------------------------------------------------------
# loaders
# ---------------------------------------------------------------------------

class _Toy:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"idx": np.asarray(i, np.int64)}


@pytest.mark.parametrize("n,shuffle", [(22, True), (21, False)])
def test_host_strided_loader_matches_jax(n, shuffle):
    """Each of two hosts gets JAX's index stream for two epochs (the pad
    to a multiple of the hosts, then every second index); within an
    epoch no sample appears twice on the hosts together except the pad's
    repeats, and every sample appears."""
    from animals3d_tpu.data import loaders as jloaders
    from animals3d_tpu_torch.data import loaders as tloaders
    bs, hosts = 4, 2
    per_epoch = -(-n // hosts)
    take = 2 * per_epoch // (bs // hosts)
    streams = []
    for host in range(hosts):
        kw = dict(batch_size=bs // hosts, shuffle=shuffle, num_workers=1,
                  seed=3, host_id=host, num_hosts=hosts, infinite=True)
        jl, tl = jloaders.Loader(_Toy(n), **kw), tloaders.Loader(_Toy(n),
                                                                 **kw)
        assert len(tl) == len(jl)
        ji, ti = iter(jl), iter(tl)
        got = [int(i) for _ in range(take) for i in next(ti)["idx"]]
        want = [int(i) for _ in range(take) for i in next(ji)["idx"]]
        assert got == want
        streams.append(got)
    for e in range(2):
        epoch = sum((s[e * per_epoch:(e + 1) * per_epoch] for s in streams),
                    [])
        assert sorted(set(epoch)) == list(range(n))
        assert len(epoch) - len(set(epoch)) == (-n) % hosts


# ---------------------------------------------------------------------------
# the step on two ranks against one
# ---------------------------------------------------------------------------

def _build_model(overrides):
    from animals3d_tpu_torch import config as tcfg
    from animals3d_tpu_torch.models import build_model
    cfg = tcfg.load_config("train_magicpony_horse", overrides=overrides)
    cfg["model"]["dataset"] = cfg["dataset"]
    model = build_model(cfg["model"], device="cpu")
    model.init_params(0)
    return model


def _local(batch):
    """This rank's rows of the global numpy `batch`, as tensors."""
    from animals3d_tpu_torch import parallel
    n = batch["images"].shape[0] // parallel.world_size()
    r = parallel.rank()
    return {k: None if v is None else torch.from_numpy(v[r * n:(r + 1) * n])
            for k, v in batch.items()}


def dp_step(model, batch, it, seed):
    """One training forward and backward of `model` on this rank's rows
    of the global `batch` (numpy), the draws from a generator seeded
    `seed`, the trained gradients averaged over the ranks: (the loss
    averaged over the ranks, {name: gradient})."""
    from animals3d_tpu_torch import parallel
    from animals3d_tpu_torch.trainer import make_optimizer
    opt = make_optimizer(model)
    gen = torch.Generator().manual_seed(seed)
    loss, _ = model.forward(_local(batch), it, gen)
    loss.backward()
    parallel.all_reduce_grads(opt.trained())
    loss = parallel.all_reduce_metrics({"loss": loss.detach()})["loss"]
    grads = {name: p.grad.clone() for name, p in model.named_parameters()
             if p.grad is not None}
    return float(loss), grads


def _dp_role(args):
    overrides, batch_file = json.loads(args[0]), args[1]
    model = _build_model(overrides)
    return dp_step(model, torch.load(batch_file, weights_only=False), DP_IT,
                   DP_SEED)


@pytest.fixture(scope="module")
def tiny_overrides():
    from test_animal_model import TINY_OVERRIDES
    return TINY_OVERRIDES


def test_two_ranks_match_one_on_the_global_batch(tiny_overrides, tmp_path):
    """MagicPony's tiny step (64², grid 8) at iteration 95,000 on two gloo
    ranks against one rank on the same global batch of `DP_BATCH`: the
    loss (rtol 1e-5), the gradient norm (rtol 1e-4) and every leaf
    (within 1e-3 of its norm), with the same random draws (each rank
    keeps its rows of the global draw) and dark targets
    (`test_torch_train.DARK`).

    Two images a rank, not one: the key features reach their Encoder32
    heads as a channels-last view, and for a batch of one image its
    degenerate batch stride sends oneDNN's convolution down another path
    whose float32 sums differ (~5e-6); that moves a silhouette face on
    most seeds and the articulation leaves by ~3e-3. From two images a
    rank on, one image's numbers do not depend on the batch beside it,
    and the two sides differ only in how the ranks' means are summed."""
    from animals3d_tpu_torch.precision import set_mixed_precision
    from test_torch_train import DARK, torch_threads
    from torch_parity import fake_batch_np
    set_mixed_precision(None)
    batch = fake_batch_np(0, B=DP_BATCH)
    for k in ("images", "dino_features"):
        batch[k] = (batch[k] * DARK).astype(np.float32)
    path = str(tmp_path / "batch.pt")
    torch.save(batch, path)
    loss2, grads2 = spawn("dp_step", [json.dumps(tiny_overrides), path])
    with torch_threads(1):
        loss1, grads1 = dp_step(_build_model(tiny_overrides), batch, DP_IT,
                                DP_SEED)
    np.testing.assert_allclose(loss2, loss1, rtol=1e-5)
    assert set(grads2) == set(grads1)
    norm = lambda g: float(torch.sqrt(sum((v.double() ** 2).sum()
                                          for v in g.values())))
    np.testing.assert_allclose(norm(grads2), norm(grads1), rtol=1e-4)
    gaps = {name: float((grads2[name] - g).norm() / g.norm())
            for name, g in grads1.items() if g.norm() > 0}
    bad = {name: gap for name, gap in gaps.items() if gap > 1e-3}
    assert not bad, bad


# ---------------------------------------------------------------------------
# the Trainer on two ranks
# ---------------------------------------------------------------------------

def _trainer_role(args):
    from animals3d_tpu_torch import checkpoint as ckpt
    from animals3d_tpu_torch import parallel
    from animals3d_tpu_torch import run
    saves = []
    real = ckpt.save_checkpoint

    def counted(*a, **kw):
        saves.append(a[1])
        return real(*a, **kw)
    ckpt.save_checkpoint = counted
    trainer = run.main(json.loads(args[0]))
    state = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    return {"rank": parallel.rank(), "dp": trainer.dp, "saves": saves,
            "state": state, "trace": trainer.metrics_trace.data["train"],
            "states": _gather(state)}


def _gather(state):
    """Every rank's `state` on rank 0 (gloo has no gather of objects to
    one rank only where all must call, so all get them)."""
    import torch.distributed as dist
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, state)
    return out


def test_trainer_on_two_ranks(tiny_overrides, tmp_path):
    """`run.main` on two gloo ranks for two iterations on a synthetic
    folder: data parallel over both (dp 2, a batch of 1 each), one
    checkpoint written, by rank 0 alone, the ranks' weights equal after
    each step's averaged update, and finite losses logged."""
    from animals3d_tpu_torch.data.synth import write_synth_dataset
    data = write_synth_dataset(str(tmp_path / "data"), n=4, size=64,
                               dino_dim=4)
    ckpt_dir = tmp_path / "ckpt"
    argv = ["--config-name", "train_magicpony_horse", "--device", "cpu",
            *tiny_overrides, f"dataset.train_data_dir={data}",
            "dataset.val_data_dir=null", "dataset.num_workers=1",
            f"checkpoint_dir={ckpt_dir}", "num_iters=2",
            "save_checkpoint_freq=5000", "use_logger=false",
            "log_loss_freq=1", "mixed_precision=false", "run_train=true"]
    got = spawn("trainer", [json.dumps(argv)])
    assert got["rank"] == 0 and got["dp"] == WORLD
    assert got["saves"] == [2]
    assert sorted(os.listdir(ckpt_dir)) == ["checkpoint0000002.pth",
                                            "metrics.json"]
    a, b = got["states"]
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert len(got["trace"]) == 2 and all(
        np.isfinite(m["loss"]) for m in got["trace"])


def test_dp_width_rule():
    """The JAX trainer's rule: every rank by default, the largest width
    dividing the batch where the ranks do not, `mesh_shape`'s dp where
    given (no more than the ranks)."""
    from animals3d_tpu_torch.parallel import dp_size
    assert dp_size(None, 8, 4) == 4
    assert dp_size(None, 6, 4) == 2
    assert dp_size({"dp": 1}, 8, 4) == 1
    with pytest.raises(ValueError):
        dp_size({"dp": 2}, 8, 1)


ROLES = {"dp_step": _dp_role, "trainer": _trainer_role}


def _rank_main(argv):
    role, store, rank, world, out, *args = argv
    torch.set_num_threads(1)
    from animals3d_tpu_torch import parallel
    from animals3d_tpu_torch.precision import set_mixed_precision
    set_mixed_precision(None)
    parallel.init_distributed("cpu", store=store, rank=int(rank),
                              world_size=int(world))
    try:
        result = ROLES[role](args)
        if parallel.rank() == 0:
            torch.save(result, out)
    finally:
        parallel.shutdown()


if __name__ == "__main__":
    _rank_main(sys.argv[1:])
