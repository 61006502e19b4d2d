"""The training loop: the epochs tying data, steps, schedules, logging and
checkpoints together (port of `dense2sparse_vit_tpu/train/loop.py::
run_experiment`).

Seeded models and teacher, the 80/20 split of an ImageNet-val folder, per
epoch the train steps, a full-coverage eval and a checkpoint, with the best
accuracy tracked and saved and an exact resume. One process drives one
device: the card unless the caller asks for the CPU.

Per train step, on the device: the uint8 batch (copied from pinned memory
without waiting) is normalised, randomly erased and mixed (mixup/cutmix);
the step's generator, from which all of these and the step's own draws
(DropPath, dropout masks, the gumbel noise, random scores, the soft top-k
noise) come, is seeded from
(seed, epoch, step); and the host transform's generator of a sample from
(seed, epoch, index) (`data/pipeline.py`). So a resumed run takes the same
batches and draws as an uninterrupted one. The metrics are summed on the
device and read only at the log cadence and at the end of an epoch.

More than one process (`core.mesh.maybe_initialize_distributed`, e.g.
under torchrun): every rank drives its own device (cuda:LOCAL_RANK) and
takes batch_size / world samples of each global batch from its round-robin
shard of the train split (`process_local_indices`; the teacher cache is
built per rank over that shard); the student trains under DDP
(`train_step.wrap_ddp`), and the step's generator is seeded from (seed,
epoch, step, rank), so dropout, DropPath, the selection noise, erasing and
mixup (which pairs samples within the rank's shard) differ by rank. The
eval splits the val images by rank too, each rank's tail padded, and sums
over the ranks, so every image counts once and every rank has the same
val metrics; the train metrics are averaged over the ranks at the log
cadence and the end of an epoch. Rank 0 alone logs, prints, writes the
checkpoints and the serving export (each write followed by a barrier) and
restores a checkpoint, which it then broadcasts. With a process group of
one rank (world size 1) the draws are the single process's and the run is
the same as without a group, DDP wrapper aside.
"""

from __future__ import annotations

import copy
import time
import warnings
from typing import Mapping, Optional

import numpy as np
import torch

from dense2sparse_vit_torch.core.config import ExperimentConfig
from dense2sparse_vit_torch.core.mesh import (
    barrier,
    distributed,
    host_local_batch,
    is_primary,
    local_rank,
    make_mesh,
    process_local_indices,
)
from dense2sparse_vit_torch.data import (
    ImageFolder,
    Mixup,
    device_normalize,
    device_random_erasing,
    eval_transform,
    make_loader,
    split_train_val_indices,
    train_transform,
)
from dense2sparse_vit_torch.models import DiffPruningStudent, DynamicViTStudent, ViTTeacher
from dense2sparse_vit_torch.parallel import all_reduce_mean, all_reduce_sums
from dense2sparse_vit_torch.train.optimizer import make_optimizer
from dense2sparse_vit_torch.train.train_step import (
    make_dynamic_vit_eval_step,
    make_dynamic_vit_train_step,
    make_eval_step,
    make_train_step,
    wrap_ddp,
)
from dense2sparse_vit_torch.utils.checkpoint import CheckpointManager
from dense2sparse_vit_torch.utils.logging import MetricsLogger, slurm_job_name


def resolve_device(device=None) -> torch.device:
    """`device`, by default the card; a card without an index is this
    rank's (cuda:LOCAL_RANK, the first card for one process). Raises where
    the card is asked for (or defaulted to) and there is none."""
    device = torch.device("cuda") if device is None else torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", local_rank())
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"run_experiment runs on {device} and there is no CUDA device: "
                           "pass device='cpu' (--device cpu) to run on the CPU")
    return device


def step_seed(seed: int, epoch: int, step: int, rank: Optional[int] = None) -> int:
    """The seed of train step `step` of `epoch`; of data rank `rank`'s
    generator where more than one rank splits the batch."""
    entropy = [seed, epoch, step] + ([] if rank is None else [rank])
    return int(np.random.SeedSequence(entropy).generate_state(1)[0])


class _NullLogger:
    """The logger of a rank other than 0: writes nothing."""

    def log(self, *args, **kwargs):
        pass

    summary = close = log


def _load_weights(module: torch.nn.Module, state: Mapping) -> None:
    module.load_state_dict({k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v) else v)
                            for k, v in state.items()})


def run_experiment(
    cfg: ExperimentConfig,
    workdir: str,
    teacher_params: Optional[Mapping] = None,
    student_params: Optional[Mapping] = None,
    resume: bool = False,
    max_steps_per_epoch: Optional[int] = None,
    viz_every: int = 1,
    eval_only: bool = False,
    report_flops: bool = False,
    export_serving: Optional[str] = None,
    device=None,
) -> dict:
    """Train the student against its frozen teacher; returns the summary.

    teacher_params / student_params: state_dicts (tensors or numpy arrays,
      e.g. from `utils.convert.state_dict_from_jax`); seeded random weights
      where None.
    resume: restore the latest checkpoint under workdir/ckpt (the student,
      the optimizer with its update count and accumulator, the micro-step
      count) and continue from its epoch, with its best metric.
    max_steps_per_epoch: truncate epochs.
    eval_only: no training; one padded full-coverage eval of the restored
      (resume=True) or given weights, refused where there are neither.
    report_flops: print the pruned and unpruned forwards' GFLOPs.
    export_serving: a directory for `ServingModel` artifacts of the best
      checkpoint (else the last weights).
    device: the device, by default the card (`resolve_device`: this rank's).
    viz_every: with cfg.visualize_patch_drop / visualize_cls_attn_evo, the
      epochs (epoch % viz_every == 0) whose end draws the student on a fixed
      panel, the first val batch's first 16 images, into workdir/viz
      (`viz.epoch_visualize`; rank 0, not for the gumbel baseline). The
      panel's forward runs in eval mode without gradients and draws from no
      training generator, so the training is the same with it as without.
    """
    device = resolve_device(device)
    tr, dc = cfg.train, cfg.data
    seed = tr.seed
    pin = device.type == "cuda"
    mesh = make_mesh()
    world, primary = mesh.shape["data"], is_primary()
    group = mesh.data_group

    def say(*args):
        if primary:
            print(*args, flush=True)

    mixup = Mixup(mixup_alpha=dc.mixup, cutmix_alpha=dc.cutmix, cutmix_minmax=dc.cutmix_minmax,
                  prob=dc.mixup_prob, switch_prob=dc.mixup_switch_prob, mode=dc.mixup_mode,
                  label_smoothing=dc.smoothing, num_classes=dc.num_classes)
    use_tcache = tr.teacher_cache and not eval_only
    if use_tcache and mixup.active:
        raise ValueError("--teacher-cache requires mixup/cutmix disabled: the teacher consumes "
                         "the mixed images, which change every step and cannot be cached")

    # data: the 80/20 split of the ImageNet-val folder
    if use_tcache:
        # the same teacher input every epoch: the deterministic eval view,
        # whose decoded uint8 samples are cached too
        if primary:
            warnings.warn(
                "--teacher-cache trains on the DETERMINISTIC eval view: RandomResizedCrop/flip/"
                "RandAugment/RandomErasing are all disabled (not just mixup). This is a "
                "materially weaker-regularized recipe than the stochastic train augmentation: "
                "use it for throughput, not for accuracy-parity runs.", stacklevel=2)
        ds_train = ImageFolder(dc.imgnet_val_dir, eval_transform(dc, normalize=False))
    else:
        # the host stops after RandAugment; Normalize and RandomErasing run
        # on the device, then mixup
        ds_train = ImageFolder(dc.imgnet_val_dir, train_transform(dc, as_uint8=True))
    ds_val = ImageFolder(dc.imgnet_val_dir, eval_transform(dc, normalize=False))
    tr_idx, va_idx = split_train_val_indices(len(ds_train), 0.8, seed=seed)
    bs = tr.batch_size
    local_bs = host_local_batch(bs, mesh)  # raises where the ranks do not divide it
    if len(va_idx) < world:
        raise ValueError(f"{len(va_idx)} val images cannot be split over {world} ranks")
    # each rank's round-robin shard of both splits (one rank: the splits)
    tr_local = process_local_indices(tr_idx, mesh)
    va_local = process_local_indices(va_idx, mesh)
    train_decoded: dict = {}  # the decoded store the cache's pre-pass and the loader share
    loaders = []

    def loader(*args, **kw):
        loaders.append(make_loader(*args, num_workers=dc.num_workers, as_uint8=True,
                                   pin_memory=True, **kw))
        return loaders[-1]

    train_loader = []  # built at its first use: the resident fast path never needs it

    def get_train_loader():
        if not train_loader:
            train_loader.append(loader(
                ds_train, local_bs, shuffle=True, seed=seed, indices=tr_local,
                with_indices=use_tcache, cache_decoded=use_tcache,
                shared_cache=train_decoded if use_tcache else None))
        return train_loader[0]

    val_bs = max(min(local_bs, len(va_local)), 1)
    # the tail batch is kept and padded (label -1): every val image counts once
    val_loader = loader(ds_val, val_bs, indices=va_local, drop_last=False, cache_decoded=True)
    # the smallest shard's count: every rank takes the same number of steps
    steps_per_epoch = max(len(tr_idx) // world // local_bs, 1)
    if max_steps_per_epoch:
        steps_per_epoch = min(steps_per_epoch, max_steps_per_epoch)

    # models: selection 'gumbel' is the DynamicViT baseline
    gumbel = cfg.pruning.selection == "gumbel"
    student = (DynamicViTStudent if gumbel else DiffPruningStudent)(cfg.model, cfg.pruning)
    student.init_weights(torch.Generator().manual_seed(seed))
    teacher = ViTTeacher(cfg.model).init_weights(torch.Generator().manual_seed(seed + 1))
    if student_params is not None:
        _load_weights(student, student_params)
    if teacher_params is not None:
        _load_weights(teacher, teacher_params)
    student.to(device)
    teacher.to(device)
    # the schedules count optimizer updates: grad_accum_steps micro-steps each
    sched_steps = max(steps_per_epoch // tr.grad_accum_steps, 1)
    opt = make_optimizer(student, tr, sched_steps, backbone_warmup_freeze=not gumbel)
    if report_flops and primary:
        from dense2sparse_vit_torch.utils.profiling import pruned_vs_dense_flops

        sample = torch.zeros((1, cfg.model.img_size, cfg.model.img_size, 3), device=device)
        student.eval()
        fl = pruned_vs_dense_flops(student, sample,
                                   **({} if gumbel else {"collect_cls_attns": False}))
        say(f"Flops [GFLOPs]: Unpruned={fl['dense_gflops']:.2f}, "
            f"Pruned={fl['pruned_gflops']:.2f}, Ratio={fl['flop_ratio']:.2f}")

    def to_dev(t: torch.Tensor) -> torch.Tensor:
        return t.to(device, non_blocking=True)

    tcache = None
    if use_tcache:
        from dense2sparse_vit_torch.train.teacher_cache import (
            TeacherCache,
            make_teacher_outputs_fn,
        )

        build_loader = loader(ds_train, local_bs, indices=tr_local, drop_last=False,
                              with_indices=True, cache_decoded=True, shared_cache=train_decoded)
        tcache = TeacherCache(tr_local)
        t_build0 = time.time()
        dev_limit = int(tr.device_cache_gb * 2**30)
        est_img_bytes = len(tr_local) * cfg.model.img_size ** 2 * 3
        tcache.build(make_teacher_outputs_fn(teacher, cfg), build_loader, local_bs, device,
                     cache_images=est_img_bytes < dev_limit)
        mib = tcache.nbytes / 2**20
        tcache.to_device(device, limit_bytes=dev_limit)
        where = ("device-resident (incl. images)" if tcache.device_has_images
                 else "device-resident (teacher rows)" if tcache.on_device else "host")
        say(f"teacher cache: {len(tr_local)} samples, {mib:.0f} MiB, {where}, "
            f"{time.time() - t_build0:.1f}s")

    ckpt = CheckpointManager(f"{workdir}/ckpt")
    step_count = 0  # micro-steps, as JAX's TrainState.step counts them
    start_epoch = 0
    restored = False
    if resume and world > 1:
        # rank 0's checkpoint decides and is restored there, then broadcast
        # (a rank's own directory may hold none): the student, the optimizer
        # with its update count and accumulator, the step and the best metric
        got = [None]
        if primary and ckpt.latest_step() is not None:
            got = [{"state": ckpt.restore(map_location="cpu"), "best": ckpt.best_metric}]
        torch.distributed.broadcast_object_list(got, src=0)
        if got[0] is not None:
            state, ckpt.best_metric = got[0]["state"], got[0]["best"]
            restored = True
    elif resume and ckpt.latest_step() is not None:
        state = ckpt.restore(map_location=device)
        restored = True
    if restored:
        student.load_state_dict(state["student"])
        opt.load_state_dict(state["optimizer"])
        step_count = int(state["step"])
        start_epoch = step_count // steps_per_epoch
    if eval_only and not restored and student_params is None:
        # a random init would report chance-level accuracy as the model's
        raise FileNotFoundError(f"--eval-only: no checkpoint under {workdir}/ckpt and no "
                                "student_params provided; nothing trained to evaluate")

    build_step = make_dynamic_vit_train_step if gumbel else make_train_step
    # under a process group the student trains through DDP (one rank too)
    net = wrap_ddp(student, cfg, mesh) if distributed() and not eval_only else student
    train_step = build_step(net, teacher, opt, cfg, mixup_active=mixup.active,
                            cached_teacher=use_tcache)
    eval_step = (make_dynamic_vit_eval_step if gumbel else make_eval_step)(student, teacher, cfg)
    logger = (MetricsLogger(workdir, slurm_job_name(cfg), use_tensorboard=True,
                            use_wandb=cfg.wandb, wandb_config={"cfg": str(cfg)})
              if primary else _NullLogger())
    # a resumed run keeps its best: the summary's best_val_acc is the run's
    best_acc = ckpt.best_metric if restored and ckpt.best_metric is not None else 0.0
    log_every = max(tr.log_every_steps, 1)
    gen = torch.Generator(device=device)

    def train_batches(epoch):
        """(images, labels, teacher rows) device batches of one epoch. The
        resident fast path (the cache holds the images on the device):
        only the (B,) index vector is copied per step."""
        if use_tcache and tcache.device_has_images:
            order = np.asarray(tr_local).copy()
            np.random.default_rng(seed + epoch).shuffle(order)
            for b in range(steps_per_epoch):
                sel = order[b * local_bs:(b + 1) * local_bs]
                if len(sel) < local_bs:
                    break  # drop-last, as the loader path
                got = tcache.lookup_device(sel)
                yield got.pop("images"), got.pop("labels").long(), got
            return
        for step_i, item in enumerate(get_train_loader()(epoch)):
            if step_i >= steps_per_epoch:
                break
            teacher_in = None
            if use_tcache:
                xb, yb, sel = item
                if tcache.on_device:
                    teacher_in = tcache.lookup_device(sel)
                else:
                    teacher_in = {k: to_dev(v.pin_memory() if pin else v)
                                  for k, v in tcache.lookup(sel).items()}
            else:
                xb, yb = item
            yield to_dev(xb), to_dev(yb).long(), teacher_in

    # the first eval's device batches are kept and fed again to later evals
    # (within what --device-cache-gb leaves after the teacher cache)
    val_dev_batches: list = []
    viz_panel: list = []  # the first val batch's (uint8 images, labels), host, 16 rows
    val_dev_limit = int(tr.device_cache_gb * 2**30) - (tcache.device_nbytes if tcache else 0)
    val_dev_ok = [val_dev_limit > 0]

    def val_batches():
        nbytes = 0
        for xb, yb in val_loader(0):
            if len(yb) < val_bs:
                pad = val_bs - len(yb)
                xb = torch.cat([xb, xb[:1].expand(pad, *xb.shape[1:])])
                yb = torch.cat([yb, torch.full((pad,), -1, dtype=yb.dtype)])
                if pin:
                    xb, yb = xb.pin_memory(), yb.pin_memory()
            if not viz_panel:
                # a host copy, taken before the batch goes to the device
                viz_panel.extend((xb[:16].numpy().copy(), yb[:16].numpy().copy()))
            xbd, ybd = to_dev(xb), to_dev(yb).long()
            if val_dev_ok[0]:
                nbytes += xbd.numel() * xbd.element_size() + ybd.numel() * ybd.element_size()
                if nbytes <= val_dev_limit:
                    val_dev_batches.append((xbd, ybd))
                else:
                    val_dev_batches.clear()
                    val_dev_ok[0] = False
            yield xbd, ybd

    def run_eval():
        """One padded full-coverage eval: (metrics averaged over the valid
        rows, their count); the weighted sums stay on the device, read
        once, summed over the ranks first."""
        agg = None
        for xbd, ybd in (list(val_dev_batches) if val_dev_batches else val_batches()):
            m = eval_step(xbd, ybd)
            n = m["n_valid"]
            w = {k: v * n for k, v in m.items() if k != "n_valid"}
            w["n_valid"] = n
            agg = w if agg is None else {k: agg[k] + w[k] for k in agg}
        agg = {k: float(v) for k, v in all_reduce_sums(agg or {}, group).items()}
        total_valid = agg.pop("n_valid", 0.0)
        if total_valid:
            agg = {k: v / total_valid for k, v in agg.items()}
        return agg, total_valid

    visualize = (cfg.visualize_patch_drop or cfg.visualize_cls_attn_evo) and not gumbel

    @torch.no_grad()
    def maybe_visualize(epoch):
        """The epoch-end pictures of the student on the panel (rank 0)."""
        if not (visualize and primary and viz_panel and epoch % viz_every == 0):
            return
        from dense2sparse_vit_torch.data.pipeline import _normalize
        from dense2sparse_vit_torch.viz import epoch_visualize

        images = _normalize(viz_panel[0], dc)  # uint8 -> normalised, the native kernel
        student.eval()
        out = student(torch.from_numpy(images).to(device),
                      collect_cls_attns=cfg.visualize_cls_attn_evo)
        epoch_visualize(images, out, cfg.model.num_patches, f"{workdir}/viz", epoch,
                        labels=viz_panel[1], patch_size=cfg.model.patch_size,
                        visualize_patch_drop=cfg.visualize_patch_drop,
                        visualize_cls_attn_evo=cfg.visualize_cls_attn_evo,
                        pruning_locs=cfg.pruning.pruning_locs)

    def maybe_export_serving():
        """--export-serving DIR: artifacts of the best checkpoint where one
        exists, else of the current weights; rank 0 writes them."""
        if not export_serving:
            return
        if not primary:
            barrier()
            return
        from dense2sparse_vit_torch.utils.serving import ServingModel

        model = student
        if ckpt.best_step() is not None:
            model = copy.deepcopy(student)
            model.load_state_dict(ckpt.restore_best(map_location=device)["student"])
        sm = ServingModel.export(model)
        sm.save(export_serving)
        say(f"serving artifacts -> {export_serving} "
            f"({'symbolic batch' if sm.symbolic else sm.buckets})")
        barrier()

    def close():
        logger.close()
        ckpt.close()
        for ld in loaders:
            ld.close()

    try:
        if eval_only:
            agg, total_valid = run_eval()
            if total_valid:
                logger.log(agg, start_epoch, prefix="val")
            summary = {"eval_only": True, "epochs": 0, **agg}
            logger.summary(summary)
            maybe_export_serving()
            return summary

        for epoch in range(start_epoch, tr.epochs):
            t0 = time.time()
            metric_sum, n_steps = None, 0
            for step_i, (xb, yb, teacher_in) in enumerate(train_batches(epoch)):
                gen.manual_seed(step_seed(seed, epoch, step_i,
                                          mesh.data_rank if world > 1 else None))
                if not use_tcache:
                    xb = device_normalize(xb, dc)
                    if dc.reprob > 0:
                        xb = device_random_erasing(xb, dc, gen)
                if mixup.active:
                    xb, yb = mixup(gen, xb, yb)
                metrics = train_step(xb, yb, epoch, teacher_in=teacher_in, generator=gen)
                step_count += 1
                metric_sum = (metrics if metric_sum is None
                              else {k: metric_sum[k] + v for k, v in metrics.items()})
                n_steps += 1
                if n_steps % log_every == 0:
                    running = {k: float(v) / n_steps
                               for k, v in all_reduce_mean(metric_sum, group).items()}
                    logger.log(running, step_count, prefix="train_step")
                    say(f"epoch {epoch} step {step_i + 1}/{steps_per_epoch} "
                        f"loss {running.get('loss', float('nan')):.4f}")
            epoch_means = ({k: float(v) / n_steps
                            for k, v in all_reduce_mean(metric_sum, group).items()}
                           if metric_sum is not None else None)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t_train = time.time() - t0  # loader and steps, up to the last step's end
            if epoch_means is not None:
                logger.log(epoch_means, epoch, prefix="train")

            agg, total_valid = run_eval()
            if total_valid:
                logger.log(agg, epoch, prefix="val")
                acc = agg.get("val_acc", 0.0)
                best_acc = max(best_acc, acc)
            # a mid-cycle accumulator is the same on every rank once averaged
            opt.sync_accumulator()
            state = {"student": student.state_dict(), "optimizer": opt.state_dict(),
                     "step": step_count}
            # the latest stream: --resume continues from here even on a plateau
            ckpt.save(step_count, state)
            if total_valid:
                ckpt.save_if_best(step_count, state, acc)
            maybe_visualize(epoch)
            logger.log({
                "epoch_seconds": time.time() - t0,
                # the train phase alone (loader and steps, no eval)
                "train_seconds": t_train,
                # the global batch: every rank's samples
                "train_img_per_s": n_steps * bs / t_train if t_train > 0 and n_steps else 0.0,
            }, epoch, prefix="time")

        summary = {
            "best_val_acc": best_acc,
            "epochs": tr.epochs,
            # > 0: later evals were fed the retained device batches
            "val_dev_batches": len(val_dev_batches),
            "train_device_resident": bool(use_tcache and tcache.device_has_images),
            # the host ships uint8; normalize and erasing finish on the device
            "augmented_train_uint8_stream": not use_tcache,
        }
        logger.summary(summary)
        maybe_export_serving()
        return summary
    finally:
        close()
