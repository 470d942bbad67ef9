"""Trainer: the training loop, checkpointing, the test path and metrics
(port of `animals3d_tpu.trainer`).

Reference: `reference model/Trainer.py` (config `:15-50`, train loop
`:232-311`, test `:129-146`). One `train_step` a batch: the eager forward,
`loss.backward()` and a step of each predictor's Adam
(`make_optimizer`). Fauna adds a separate discriminator step after it in
its discriminator window (`disc_step`): its own Adam on `netDisc`, which
the generator's optimizers never touch. Checkpoints are `torch.save`
files with the model's, the optimizers' and the schedulers' state
(`checkpoint.py`); metrics go to stdout, `metrics.json` and the logger:
tensorboardX where it imports, or wandb (`logger_type: wandb`, a no-op
without the package). Every `log_image_freq` iterations the logger also
gets the visuals of the eval forward (images, masks, DINO features,
histograms, geometry normals with the bones, albedo, shading) and
turntable videos of the posed and prior shapes, on the training batch and
on a validation batch; unlike the JAX trainer, a failure there is not
swallowed. `archive_code` zips the port's own sources next to the
checkpoints. Data parallelism (`mesh_shape` {"dp": N}, or every rank of
the process group where it is None) runs one process a device
(`animals3d_tpu_torch.parallel`): each rank takes its stride of the
loaders, the gradients are averaged over the ranks before each Adam step
(the discriminator's too), metrics are averaged for logging, and rank 0
alone writes checkpoints, logs, archives and the training results.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import time
from typing import Any, Optional

import numpy as np
import torch

from animals3d_tpu_torch import checkpoint as ckpt
from animals3d_tpu_torch import config as cfglib
from animals3d_tpu_torch import parallel, tracing
from animals3d_tpu_torch.data.loaders import (DataLoaderConfig,
                                              get_data_loaders)
from animals3d_tpu_torch.precision import set_mixed_precision
from animals3d_tpu_torch.utils.meters import MetricsTrace, StandardMetrics


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    run_train: bool = False
    run_test: bool = False
    seed: int = 0
    num_iters: int = 1
    checkpoint_dir: str = "results"
    checkpoint_name: Optional[str] = None
    save_checkpoint_freq: int = 5000
    keep_num_checkpoint: int = 2
    resume: bool = True
    archive_code: bool = False
    test_result_dir: Optional[str] = None
    checkpoint_path: Optional[str] = None   # warm-start file (ours or .pth)
    load_optim: bool = True
    use_logger: bool = True
    logger_type: str = "tensorboard"
    log_loss_freq: int = 50
    log_image_freq: int = 500
    log_train: bool = True
    log_val: bool = True
    fix_log_batch: bool = False
    save_train_result_freq: Optional[int] = None
    mixed_precision: Optional[str] = "bf16"
    # torch.autograd.set_detect_anomaly: the backward raises at the first
    # op that makes a NaN instead of at the finite-loss check; slow
    debug_nans: bool = False
    # read nowhere, as in the JAX trainer: the discriminator step runs
    # whenever the phase's `disc_on` is set
    disc_train: bool = False
    remake_dataloader_iter: int = -1
    remake_dataloader_num: int = -1
    # read nowhere, as in the JAX trainer: FaunaDataset always reshuffles
    shuffle_dataset_paths: bool = True
    mesh_shape: Optional[Any] = None
    # where set, the run's spans and counters (`tracing`) are written there
    # as a Chrome trace at each checkpoint and at the end (rank r > 0
    # writes `<trace_file>.rank<r>`)
    trace_file: Optional[str] = None


class Optimizer:
    """One Adam (AdamW where `weight_decay` is non-zero) per predictor,
    `base` (netBase) and `instance` (netInstance), each with its config's
    learning rate and, where `use_scheduler` is set, a MultiStepLR stepped
    once per iteration. Frozen parameters, which the model keeps without
    gradient (the DINO ViT, and those its `frozen_param` names:
    Ponymation's stages), are in no group, and a predictor with none left
    gets no optimizer (Ponymation's stage 1 has no `base` Adam), as the
    JAX trainer's `set_to_zero` partitions leave them where they are.
    A model with a discriminator (Fauna) also gets `disc`, a plain Adam on
    `netDisc` at `cfg_optim_discriminator.lr` (`optax.adam` in the JAX
    trainer), which `step` and `zero_grad` leave alone: `disc_step` runs
    it. Its state is saved with the others but never restored: the JAX
    trainer keeps no such state and starts the discriminator's Adam afresh
    at the first discriminator step of every run, a resumed one too."""

    def __init__(self, model):
        self.optimizers, self.schedulers = {}, {}
        self.disc = None
        if getattr(model, "netDisc", None) is not None:
            self.disc = torch.optim.Adam(
                model.netDisc.parameters(),
                lr=model.cfg_optim_discriminator.lr, eps=1e-8)
        for name, net, cfg in (
                ("base", model.netBase, model.cfg_optim_base),
                ("instance", model.netInstance, model.cfg_optim_instance)):
            params = [p for p in net.parameters() if p.requires_grad]
            if not params:
                continue
            if cfg.weight_decay:
                # optax.adamw's defaults: eps 1e-8, decoupled decay
                opt = torch.optim.AdamW(params, lr=cfg.lr, eps=1e-8,
                                        weight_decay=cfg.weight_decay)
            else:
                opt = torch.optim.Adam(params, lr=cfg.lr, eps=1e-8)
            self.optimizers[name] = opt
            if cfg.use_scheduler:
                self.schedulers[name] = torch.optim.lr_scheduler.MultiStepLR(
                    opt, milestones=[int(m) for m in cfg.scheduler_milestone],
                    gamma=cfg.scheduler_gamma)

    def step(self):
        """A step of every optimizer. A grouped parameter the step did not
        reach (netDeform before its phase; netArticulation in Ponymation's
        stage 1 before articulation starts) takes a zero gradient, as in
        the JAX trainer, whose optax Adam counts every step of a
        partition: torch's Adam skips a parameter without gradient, and
        would start its bias correction later."""
        for opt in self.optimizers.values():
            for group in opt.param_groups:
                for p in group["params"]:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
            opt.step()
        for sched in self.schedulers.values():
            sched.step()

    def trained(self) -> list:
        """The parameters of every optimizer but `disc`."""
        return [p for opt in self.optimizers.values()
                for g in opt.param_groups for p in g["params"]]

    def zero_grad(self, set_to_none: bool = True):
        for opt in self.optimizers.values():
            opt.zero_grad(set_to_none=set_to_none)

    def _all(self) -> dict:
        """Every optimizer by name, `disc` included where there is one."""
        return {**self.optimizers,
                **({"disc": self.disc} if self.disc is not None else {})}

    def state_dict(self) -> dict:
        return {"optimizer": {k: o.state_dict()
                              for k, o in self._all().items()},
                "scheduler": {k: s.state_dict()
                              for k, s in self.schedulers.items()}}

    def load_state_dict(self, state: dict) -> None:
        """Load each optimizer's and scheduler's saved state where it is
        present and, for an optimizer, its parameter groups have the sizes
        of this one's (strict=False); the rest keep their init, and both
        lists are printed. A saved `disc` state is passed over: the
        discriminator's Adam starts afresh (see the class)."""
        missing, unexpected = [], []
        for section, objs in (("optimizer", self.optimizers),
                              ("scheduler", self.schedulers)):
            saved = dict(state.get(section) or {})
            if section == "optimizer":
                saved.pop("disc", None)
            unexpected += [f"{section}/{k}" for k in saved if k not in objs]
            for name, obj in objs.items():
                sd = saved.get(name)
                if sd is None or (section == "optimizer" and [
                        len(g["params"]) for g in sd["param_groups"]] != [
                        len(g["params"]) for g in obj.param_groups]):
                    missing.append(f"{section}/{name}")
                    continue
                obj.load_state_dict(sd)
        ckpt._report("optimizer state", missing, unexpected)


def make_optimizer(model) -> Optimizer:
    return Optimizer(model)


def train_step(model, optimizer: Optimizer, batch, total_iter, gen=None,
               phase=None, noise=None):
    """One training step: forward, backward, the gradients averaged over
    the data-parallel ranks (where a group is up), optimizer step. Returns
    the metrics (detached tensors)."""
    with tracing.span("train_step"):
        with tracing.span("forward"):
            loss, (metrics, _aux) = model.forward(batch, total_iter, gen,
                                                  phase, noise=noise)
        if loss.requires_grad:   # else no trained parameter reaches the loss
            with tracing.span("backward"):
                loss.backward()
        with tracing.span("all_reduce"):
            parallel.all_reduce_grads(optimizer.trained())
        with tracing.span("adam"):
            optimizer.step()
            optimizer.zero_grad(set_to_none=True)
        out = {k: v.detach() if torch.is_tensor(v) else v
               for k, v in metrics.items()}
        # the step's outputs are freed inside its span, not after it
        del loss, metrics, _aux
        return out


def disc_step(model, optimizer: Optimizer, record):
    """The discriminator's step on the masks the generator step recorded:
    `discriminator_loss` (its R1 penalty included), backward into
    `netDisc` alone, its gradients averaged over the data-parallel ranks,
    a step of the `disc` Adam. The generator's backward leaves gradients
    on `netDisc`; they are dropped first. Returns the detached loss."""
    with tracing.span("disc_step"):
        model.netDisc.zero_grad(set_to_none=True)
        loss = model.discriminator_loss(record)
        loss.backward()
        with tracing.span("all_reduce"):
            parallel.all_reduce_grads(list(model.netDisc.parameters()))
        optimizer.disc.step()
        model.netDisc.zero_grad(set_to_none=True)
        return loss.detach()


def batch_to_device(batch: dict, device) -> dict:
    """A loader's numpy batch as tensors on `device` (None stays None)."""
    return {k: None if v is None else torch.as_tensor(np.asarray(v)).to(
        device, non_blocking=True) for k, v in batch.items()}


class Trainer:
    def __init__(self, cfg: dict, model):
        self.cfg_full = cfg
        self.cfg = cfglib.bind(TrainerConfig, cfg)
        self.model = model
        set_mixed_precision(self.cfg.mixed_precision)
        if self.cfg.debug_nans:
            torch.autograd.set_detect_anomaly(True)
        ds_cfg = dict(cfg.get("dataset") or {})
        ds_cfg.pop("path", None)
        self.cfg_dataset = cfglib.bind(DataLoaderConfig, ds_cfg)
        # the data-parallel width; ranks beyond it sit the run out
        self.dp = parallel.dp_size(self.cfg.mesh_shape,
                                   self.cfg_dataset.batch_size,
                                   parallel.ranks())
        parallel.set_width(self.dp)
        self.metrics_trace = MetricsTrace()
        self._writer = None
        self._fixed_val_batch = None
        self._val_iter = None
        self.optimizer = None
        self.start_iter = None

    # ------------------------------------------------------------------
    def _logger(self):
        """The logger under `<checkpoint_dir>/logs`: a `WandbWriter` where
        `logger_type` is wandb, else tensorboardX's writer, or None where
        logging is off or tensorboardX does not import."""
        if not self.cfg.use_logger or self._writer is not None:
            return self._writer
        logdir = os.path.join(self.cfg.checkpoint_dir, "logs")
        os.makedirs(logdir, exist_ok=True)
        if self.cfg.logger_type == "wandb":
            from animals3d_tpu_torch.utils.wandb_writer import WandbWriter
            self._writer = WandbWriter(config=self.cfg_full)
        else:
            try:
                from tensorboardX import SummaryWriter
                self._writer = SummaryWriter(logdir, flush_secs=10)
            except ImportError:
                self._writer = None
        return self._writer

    def _archive_code(self):
        """Zip the port's `.py` and `.yaml` sources to
        `<checkpoint_dir>/code.zip` (`misc.archive_code`, `misc.py:75-85`);
        returns its path."""
        import zipfile
        import animals3d_tpu_torch
        pkg = os.path.dirname(animals3d_tpu_torch.__file__)
        os.makedirs(self.cfg.checkpoint_dir, exist_ok=True)
        out = os.path.join(self.cfg.checkpoint_dir, "code.zip")
        with zipfile.ZipFile(out, "w", zipfile.ZIP_DEFLATED) as zf:
            for root, _dirs, files in os.walk(pkg):
                for fn in files:
                    if fn.endswith((".py", ".yaml")):
                        p = os.path.join(root, fn)
                        zf.write(p, os.path.relpath(p, os.path.dirname(pkg)))
        return out

    def _log_visuals(self, writer, batch, total_iter, prefix="train_"):
        """The visuals of the eval forward on the host `batch` at
        `total_iter` (`Trainer.py:283-303`, `AnimalModel.log_visuals`,
        `AnimalModel.py:517-636`), with the geo_normal, kd and shading
        renders, and the turntable videos."""
        if writer is None:
            return
        from animals3d_tpu_torch.utils import visual_log
        model = self.model
        aux = self._eval_aux(batch_to_device(batch, model.device),
                             total_iter,
                             torch.Generator(device=model.device)
                             .manual_seed(0))
        extra = None
        if aux.get("mvp") is not None and model.cfg_model.enable_render:
            h = w = model.out_image_size
            with torch.no_grad():
                extra = model.render(
                    ["geo_normal", "kd", "shading"], aux["shape"],
                    aux["mvp"], aux["w2c"], aux["campos"], (h, w),
                    im_features=aux["im_features"],
                    light_params=aux["light_params"],
                    prior_mesh=aux["prior_mesh"],
                    num_frames=model.num_frames,
                    class_vector=aux.get("class_vector"))
        visual_log.log_visuals(model, writer, batch, aux, extra, total_iter,
                               prefix=prefix)
        visual_log.log_videos(writer, self._turntable_videos(aux),
                              total_iter, prefix=prefix)

    @torch.no_grad()
    def _turntable_videos(self, aux, num_frames=15):
        """15-frame azimuth turntables of the first posed shape (its
        geometry normals) and of the prior (shaded and normals)
        (`AnimalModel.render_rotation_frames`, `:665-701`)."""
        from animals3d_tpu_torch.visualization import orbit_cameras
        model = self.model
        if aux.get("mvp") is None:
            return {}
        h = w = model.out_image_size

        def first(key):
            return None if aux.get(key) is None else aux[key][:1]

        shape1, prior = aux["shape"].first_n(1), aux["prior_mesh"]
        mvp, w2c, campos = first("mvp"), first("w2c"), first("campos")
        feats, light = first("im_features"), first("light_params")
        cvec = first("class_vector")
        vids = {"instance_normal_rotation": [],
                "prior_image_rotation": [], "prior_normal_rotation": []}
        for a in np.linspace(0, 2 * np.pi, num_frames, endpoint=False):
            cams = orbit_cameras(mvp[0], w2c[0], campos[0], [float(a)])

            def render(mesh, modes):
                r = model.render(modes, mesh, *cams, (h, w),
                                 im_features=feats, light_params=light,
                                 prior_mesh=prior, num_frames=1,
                                 class_vector=cvec)
                return {k: v[0, :3].cpu().numpy() for k, v in r.items()}

            posed = render(shape1, ["geo_normal"])
            rest = render(prior, ["geo_normal", "shaded"])
            vids["instance_normal_rotation"].append(posed["geo_normal"])
            vids["prior_image_rotation"].append(rest["shaded"])
            vids["prior_normal_rotation"].append(rest["geo_normal"])
        return vids

    def _log_val_visuals(self, writer, val_loader, total_iter):
        """One validation batch's visuals (`Trainer.py:291-303`): the next
        batch of `val_loader`, or the first one again with
        `fix_log_batch`."""
        if self._val_iter is None:
            self._val_iter = iter(val_loader)
        try:
            val_batch = self._fixed_val_batch if \
                self._fixed_val_batch is not None else next(self._val_iter)
        except StopIteration:
            self._val_iter = iter(val_loader)
            val_batch = next(self._val_iter)
        if self.cfg.fix_log_batch:
            self._fixed_val_batch = val_batch
        self._log_visuals(writer, val_batch, total_iter, prefix="val_")

    def _eval_aux(self, batch, it, gen):
        """The eval-mode forward's aux at iteration `it` (no gradients)."""
        phase = self.model.phase_for_iter(it, is_training=False)
        with torch.no_grad(), tracing.span("forward"):
            _, (_metrics, aux) = self.model.forward(batch, it, gen, phase)
        return aux

    def restore(self):
        """Initialize from `seed`, then resume from the latest checkpoint
        of `checkpoint_dir` (optimizer and scheduler state included) or,
        at iteration 0, warm-start from `checkpoint_path`. Returns (the
        `Optimizer`, the iteration to start at)."""
        cfg = self.cfg
        self.model.init_params(cfg.seed)
        optimizer = make_optimizer(self.model)
        total_iter = 0
        if cfg.resume:
            total_iter = ckpt.load_checkpoint(cfg.checkpoint_dir, self.model,
                                              optimizer)
        if total_iter == 0 and cfg.checkpoint_path:
            # warm start (`config/train_ponymation_horse_stage1.yaml:48`:
            # stage configs start from a MagicPony / stage-1 checkpoint)
            self._warm_start(cfg.checkpoint_path,
                             optimizer if cfg.load_optim else None)
        return optimizer, total_iter

    def _warm_start(self, path, optimizer=None):
        """Tolerant warm start (strict=False, `AnimalModel.py:127-132`) from
        the port's own checkpoint file, with its optimizer and scheduler
        state where `optimizer` is given, or from a reference `.pth`
        (`convert.convert_checkpoint`; its weights only)."""
        from animals3d_tpu_torch.convert_jax import load_jax_params
        state = ckpt.read_checkpoint(path)
        if "model" in state:
            ckpt.load_model_state(self.model, state["model"],
                                  what="warm start")
            if optimizer is not None:
                optimizer.load_state_dict(state)
            return
        from animals3d_tpu_torch import convert
        load_jax_params(self.model, convert.convert_checkpoint(path,
                                                               self.model),
                        strict=False)

    # ------------------------------------------------------------------
    @contextlib.contextmanager
    def _traced(self):
        """Where `trace_file` is set, record the block's spans and counters
        and write them at its end."""
        if not self.cfg.trace_file:
            yield
            return
        tracing.enable()
        try:
            yield
            self._write_trace()
        finally:
            tracing.disable()

    def _write_trace(self):
        if self.cfg.trace_file:
            r = parallel.rank()
            tracing.write(self.cfg.trace_file + (f".rank{r}" if r else ""))

    def _loaders(self):
        """This rank's (train, val, test) loaders."""
        return get_data_loaders(self.cfg_dataset, host_id=parallel.rank(),
                                num_hosts=self.dp)

    def train(self):
        with self._traced():
            return self._train()

    def _train(self):
        cfg = self.cfg
        model = self.model
        if not parallel.in_group():
            print(f"rank outside the dp group of {self.dp}: not training")
            return model
        optimizer, total_iter = self.restore()
        parallel.broadcast_params(model)
        self.optimizer, self.start_iter = optimizer, total_iter
        main = parallel.is_main()

        train_loader, val_loader, _ = self._loaders()
        if train_loader is None:
            raise ValueError("dataset.train_data_dir is not configured")
        writer = self._logger() if main else None
        if cfg.archive_code and main:
            self._archive_code()
        metrics = StandardMetrics()
        epoch_len = max(len(train_loader), 1)
        gen = torch.Generator(device=model.device).manual_seed(cfg.seed)

        if main:
            print(f"training {model.name}: {cfg.num_iters} iters from "
                  f"{total_iter}, batch {self.cfg_dataset.batch_size}, "
                  f"device {model.device}, dp {self.dp}")
        t_start = time.time()
        train_iter = iter(train_loader)
        while total_iter < cfg.num_iters:
            if cfg.remake_dataloader_iter > 0 and \
                    total_iter == cfg.remake_dataloader_iter:
                # Fauna curriculum re-split (`Trainer.py:237-242`)
                self.cfg_dataset = dataclasses.replace(
                    self.cfg_dataset,
                    dataset_split_num=cfg.remake_dataloader_num)
                train_loader, val_loader, _ = self._loaders()
                train_iter = iter(train_loader)
            with tracing.span("load"):
                try:
                    batch = next(train_iter)
                except StopIteration:
                    train_iter = iter(train_loader)
                    batch = next(train_iter)
                device_batch = batch_to_device(batch, model.device)

            phase = model.phase_for_iter(total_iter)
            step_metrics = train_step(model, optimizer, device_batch,
                                      total_iter, gen, phase)
            # Fauna: the discriminator's step on the recorded masks
            # (`Trainer.py:248-259`), in its window
            disc_record = step_metrics.pop("_disc_record", None)
            if disc_record is not None and phase.disc_on and \
                    optimizer.disc is not None:
                step_metrics["discriminator_loss"] = disc_step(
                    model, optimizer, disc_record)
            total_iter += 1

            metrics.add_images(batch["images"].shape[0])
            if total_iter % cfg.log_loss_freq == 0 or total_iter == 1:
                with tracing.span("log"):
                    # the global batch's means, as the JAX trainer logs them
                    step_metrics = parallel.all_reduce_metrics(step_metrics)
                    host_metrics = {k: float(v)
                                    for k, v in step_metrics.items()
                                    if torch.is_tensor(v) and v.ndim == 0}
                if not math.isfinite(host_metrics.get("loss", 0.0)):
                    # the reference drops into pdb on a NaN loss
                    # (`AnimalModel.py:504-506`); fail fast with context
                    raise FloatingPointError(
                        f"non-finite loss at iter {total_iter}: "
                        f"{host_metrics}")
                bsz = batch["images"].shape[0]
                metrics.update(host_metrics, bsz)
                epoch = total_iter // epoch_len
                if main:
                    print(f"T{total_iter:07d}/{epoch:04d}/{metrics}")
                if writer is not None:
                    for k, v in host_metrics.items():
                        writer.add_scalar(f"train_loss/{k}", v, total_iter)
                    writer.add_scalar("train/speed", metrics.speed.get(),
                                      total_iter)
                self.metrics_trace.push(epoch, "train", host_metrics)

            if cfg.save_train_result_freq and \
                    total_iter % cfg.save_train_result_freq == 0:
                # eval-mode forward on the current batch, artifacts to
                # train_results/ (`Trainer.py:281-284`); every rank runs
                # the forward, rank 0 writes its own rows
                from animals3d_tpu_torch.utils import results_io
                aux = self._eval_aux(device_batch, total_iter - 1, gen)
                if main:
                    train_result_dir = os.path.join(cfg.checkpoint_dir,
                                                    "train_results")
                    os.makedirs(train_result_dir, exist_ok=True)
                    results_io.save_results(model, batch, aux,
                                            train_result_dir,
                                            start_index=total_iter)

            if writer is not None and cfg.log_image_freq and \
                    total_iter % cfg.log_image_freq == 0 and \
                    model.cfg_model.enable_render:
                # rank 0's own batches, as one process
                with parallel.local_only():
                    if cfg.log_train:
                        self._log_visuals(writer, batch, total_iter)
                    if cfg.log_val and val_loader is not None:
                        self._log_val_visuals(writer, val_loader, total_iter)

            if total_iter % cfg.save_checkpoint_freq == 0:
                if main:
                    ckpt.save_checkpoint(
                        cfg.checkpoint_dir, total_iter,
                        {"model": model.state_dict(),
                         **optimizer.state_dict()},
                        keep_num=cfg.keep_num_checkpoint)
                    self.metrics_trace.save(
                        os.path.join(cfg.checkpoint_dir, "metrics.json"))
                self._write_trace()

        if main:
            ckpt.save_checkpoint(cfg.checkpoint_dir, total_iter,
                                 {"model": model.state_dict(),
                                  **optimizer.state_dict()},
                                 keep_num=cfg.keep_num_checkpoint)
            self.metrics_trace.save(os.path.join(cfg.checkpoint_dir,
                                                 "metrics.json"))
        if writer is not None:
            writer.flush()
        wall = time.time() - t_start
        if main:
            print(f"done: {total_iter} iters in {wall:.1f}s "
                  f"({metrics.speed.get():.2f} imgs/s)")
        return model

    # ------------------------------------------------------------------
    def test(self):
        """Load the named (or latest) checkpoint, run the eval forward at
        iteration max(total_iter, 1) - 1 over the test loader and write
        `results_io.save_results` files. Returns the result directory.
        Under data parallelism each rank takes its stride of the test set
        (the last batch as long on every rank, by the loader's pad) and
        writes its rows under their index in the global batch."""
        with self._traced():
            return self._test()

    def _test(self):
        from animals3d_tpu_torch.utils import results_io
        cfg = self.cfg
        model = self.model
        if not parallel.in_group():
            return None
        model.init_params(cfg.seed)
        total_iter = ckpt.load_checkpoint(cfg.checkpoint_dir, model,
                                          checkpoint_name=cfg.checkpoint_name)
        _, _, test_loader = self._loaders()
        if test_loader is None:
            raise ValueError("dataset.test_data_dir is not configured")
        result_dir = cfg.test_result_dir or os.path.join(
            cfg.checkpoint_dir, f"test_results_{total_iter:07d}")
        os.makedirs(result_dir, exist_ok=True)
        it = max(total_iter, 1) - 1
        count = 0
        for batch in test_loader:
            n = batch["images"].shape[0]
            first = count * self.dp + parallel.rank() * n   # global row
            gen = torch.Generator(device=model.device).manual_seed(
                cfg.seed + count * self.dp)
            aux = self._eval_aux(batch_to_device(batch, model.device), it,
                                 gen)
            results_io.save_results(model, batch, aux, result_dir,
                                    start_index=first)
            count += n
        print(f"saved {count} test results to {result_dir}")
        return result_dir
