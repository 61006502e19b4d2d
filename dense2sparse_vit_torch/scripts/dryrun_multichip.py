"""Multi-process dry run: the training modes on a data x model mesh of
processes, one step each (counterpart of the JAX package's
`__graft_entry__.py::dryrun_multichip`).

    python -m dense2sparse_vit_torch.scripts.dryrun_multichip --nprocs 4 --device cpu

spawns the ranks (gloo on the CPU, NCCL on the cards, one card a rank) and
lays them out as JAX lays out its devices: with four or more (an even
number) the mesh is data = n / 2 x model = 2, else n x 1. At JAX's tiny
shapes (32 px, patch 8, C = 32, depth 4, stages at blocks 1 and 2) it runs
one top-k step of the student split Megatron-style over the model group
and under DDP over the data group, one step of the same student from the
teacher cache (each data rank's cache over its own rows), one step of the
gumbel baseline with replicated weights, and the eval step; then saves the
split student (gathered into the full tensors, written by rank 0) and
restores it into the split layout, which must be bit-identical. Rank 0
prints one summary line.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch


def _rank(rank: int, nprocs: int, port: int, device_type: str, workdir: str) -> None:
    torch.set_num_threads(1)
    from dense2sparse_vit_torch.core.config import (
        ExperimentConfig,
        ModelConfig,
        PruningConfig,
        TrainConfig,
    )
    from dense2sparse_vit_torch.core.mesh import (
        local_device,
        local_rows,
        make_mesh,
        maybe_initialize_distributed,
        process_local_indices,
    )
    from dense2sparse_vit_torch.models import DiffPruningStudent, DynamicViTStudent, ViTTeacher
    from dense2sparse_vit_torch.parallel import all_reduce_mean, all_reduce_sums
    from dense2sparse_vit_torch.parallel.tensor_parallel import parallelize
    from dense2sparse_vit_torch.train.optimizer import make_optimizer
    from dense2sparse_vit_torch.train.teacher_cache import TeacherCache, make_teacher_outputs_fn
    from dense2sparse_vit_torch.train.train_step import (
        make_dynamic_vit_train_step,
        make_eval_step,
        make_train_step,
        wrap_ddp,
    )
    from dense2sparse_vit_torch.utils.checkpoint import (
        CheckpointManager,
        restore_tensor_parallel,
        save_tensor_parallel,
    )

    maybe_initialize_distributed(f"127.0.0.1:{port}", nprocs, rank, device_type=device_type)
    dev = local_device(device_type)
    model_par = 2 if (nprocs % 2 == 0 and nprocs >= 4) else 1
    mesh = make_mesh(data=nprocs // model_par, model=model_par)

    model_cfg = ModelConfig(img_size=32, patch_size=8, embed_dim=32, depth=4, num_heads=2,
                            num_classes=10)
    cfg = ExperimentConfig(
        model=model_cfg,
        pruning=PruningConfig(pruning_locs=(1, 2), keep_ratios=(0.75, 0.5)),
        train=TrainConfig(batch_size=2 * nprocs, epochs=4, warmup_epochs=1),
    )
    B = cfg.train.batch_size
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.standard_normal((B, 32, 32, 3)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 10, B))
    x, y = local_rows(images, mesh).to(dev), local_rows(labels, mesh).to(dev)

    def metric(m, key):
        return float(all_reduce_mean({key: m[key]}, mesh.data_group)[key])

    # the student, split over the model group, under DDP over the data group
    student = DiffPruningStudent(model_cfg, cfg.pruning).init_weights(
        torch.Generator().manual_seed(2))
    teacher = ViTTeacher(model_cfg).init_weights(torch.Generator().manual_seed(3)).to(dev)
    student = parallelize(student, mesh).to(dev)
    opt = make_optimizer(student, cfg.train, 10)
    step = make_train_step(wrap_ddp(student, cfg, mesh), teacher, opt, cfg)
    loss = metric(step(x, y, 0), "loss")
    assert np.isfinite(loss), f"non-finite loss {loss}"
    assert opt.count == 1

    # the cached-teacher step: each data rank's cache over its own rows
    idx = np.arange(2 * B)
    imgs_u8 = rng.integers(0, 255, (2 * B, 32, 32, 3)).astype(np.uint8)
    mine = process_local_indices(idx, mesh)
    local_b = len(mine) // 2

    def cache_loader():
        for b in range(0, len(mine), local_b):
            sel = mine[b:b + local_b]
            yield torch.from_numpy(imgs_u8[sel]), torch.zeros(len(sel), dtype=torch.long), sel

    tcache = TeacherCache(mine)
    tcache.build(make_teacher_outputs_fn(teacher, cfg), cache_loader, local_b, dev,
                 cache_images=True)
    assert tcache.to_device(dev)
    got = tcache.lookup_device(mine[local_b // 2:local_b // 2 + local_b])
    xb, yb = got.pop("images"), got.pop("labels").long()
    cached = make_train_step(wrap_ddp(student, cfg, mesh), teacher, opt, cfg, cached_teacher=True)
    loss_cached = metric(cached(xb, yb, 0, teacher_in=got), "loss")
    assert np.isfinite(loss_cached), f"non-finite cached loss {loss_cached}"

    # the gumbel baseline: replicated weights, the batch split over 'data'
    g_cfg = cfg.replace(pruning=cfg.pruning.replace(selection="gumbel"))
    g_student = DynamicViTStudent(model_cfg, g_cfg.pruning).init_weights(
        torch.Generator().manual_seed(8)).to(dev)
    g_opt = make_optimizer(g_student, cfg.train, 10, backbone_warmup_freeze=False)
    g_step = make_dynamic_vit_train_step(wrap_ddp(g_student, g_cfg, mesh), teacher, g_opt, g_cfg)
    gen = torch.Generator(device=dev).manual_seed(9 + mesh.data_rank)
    loss_gumbel = metric(g_step(x, y, 0, generator=gen), "loss")
    assert np.isfinite(loss_gumbel), f"non-finite gumbel loss {loss_gumbel}"
    assert g_opt.count == 1

    # the eval step on every data rank's rows, summed over the data group
    m = make_eval_step(student, teacher, cfg)(x, y)
    n = m["n_valid"]
    sums = all_reduce_sums({k: v * n for k, v in m.items() if k != "n_valid"} | {"n": n},
                           mesh.data_group)
    top1, unpruned = float(sums["val_acc"] / sums["n"]), float(sums["unpruned_acc"] / sums["n"])
    assert np.isfinite(float(sums["val_loss"]))
    assert 0.0 <= top1 <= 1.0 and 0.0 <= unpruned <= 1.0

    # the split student's checkpoint round trip, bit for bit
    ckpt = CheckpointManager(workdir)
    local = {k: v.detach().cpu().clone() for k, v in student.state_dict().items()}
    save_tensor_parallel(ckpt, opt.count, local, mesh)
    restored = restore_tensor_parallel(ckpt, mesh)
    assert restored.keys() == local.keys()
    for k, v in local.items():
        assert torch.equal(restored[k], v), f"checkpoint round trip not bit-identical: {k}"
    student.load_state_dict(restored)

    if rank == 0:
        print(f"dryrun_multichip OK: {nprocs} processes, mesh {mesh.shape}, loss={loss:.4f}, "
              f"cached-teacher loss={loss_cached:.4f}, gumbel loss={loss_gumbel:.4f}, "
              f"eval top-1={top1:.3f} (unpruned {unpruned:.3f}), ckpt save->restore "
              "bit-identical across the mesh", flush=True)
    torch.distributed.destroy_process_group()


def dryrun_multichip(nprocs: int, device_type: str = "cuda") -> None:
    """Spawn `nprocs` ranks and run the dry run (module docstring); raises
    if a rank fails."""
    import torch.multiprocessing as mp

    from dense2sparse_vit_torch.core.mesh import free_port

    with tempfile.TemporaryDirectory() as workdir:
        mp.spawn(_rank, args=(nprocs, free_port(), device_type, os.path.join(workdir, "ckpt")),
                 nprocs=nprocs)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--nprocs", type=int, default=4)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    if args.device == "cuda" and torch.cuda.device_count() < args.nprocs:
        raise RuntimeError(f"{args.nprocs} ranks need {args.nprocs} cards (NCCL takes one a "
                           f"rank); {torch.cuda.device_count()} here. --device cpu runs on gloo")
    dryrun_multichip(args.nprocs, args.device)


if __name__ == "__main__":
    main()
