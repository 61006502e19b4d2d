"""Data-parallel hello world: a toy convnet trained in one process and
under DDP, with the same losses (port of
`dense2sparse_vit_tpu/experiments/spmd_hello_world.py`, itself after the
reference's ddp_hello_world.py).

The JAX version runs one jitted step under two device placements; here the
same step runs unwrapped in one process and, with a mesh, under DDP over
its data group, each rank on its contiguous rows of the batch (gloo on the
CPU, NCCL on the card). Full-batch Adam, so the two must agree to rounding:

    python -m dense2sparse_vit_torch.experiments.spmd_hello_world --nprocs 2 --device cpu
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from dense2sparse_vit_torch.core.mesh import Mesh, local_rows
from dense2sparse_vit_torch.parallel import all_reduce_mean


class ToyConvNet(nn.Module):
    """conv3x3(16) relu avgpool2 conv3x3(32) relu avgpool2 fc(64) relu fc;
    NHWC images in, 'SAME' padding as flax's Conv."""

    def __init__(self, num_classes: int = 10, img: int = 16):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 16, 3, padding=1)
        self.conv2 = nn.Conv2d(16, 32, 3, padding=1)
        self.fc1 = nn.Linear(32 * (img // 4) ** 2, 64)
        self.fc2 = nn.Linear(64, num_classes)

    def forward(self, x):
        x = F.avg_pool2d(F.relu(self.conv1(x.permute(0, 3, 1, 2))), 2)
        x = F.avg_pool2d(F.relu(self.conv2(x)), 2)
        return self.fc2(F.relu(self.fc1(x.flatten(1))))


def make_synthetic_data(n=256, img=16, classes=10, seed=0):
    """Separable synthetic data so a few steps show real learning."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, classes, n)
    base = rng.normal(size=(classes, img, img, 3)).astype(np.float32)
    images = base[labels] + 0.3 * rng.normal(size=(n, img, img, 3)).astype(np.float32)
    return torch.from_numpy(images), torch.from_numpy(labels)


def train(images, labels, *, mesh: Optional[Mesh] = None, steps=20, lr=1e-2, seed=0):
    """Train the toy net on the full batch with Adam; with a mesh, under DDP
    over its data group, each rank on its rows. Returns (model, loss, acc)
    of the last step over the whole batch."""
    torch.manual_seed(seed)
    model = ToyConvNet(img=images.shape[1]).to(images.device)
    net = model
    if mesh is not None:
        images, labels = local_rows(images, mesh), local_rows(labels, mesh)
        net = torch.nn.parallel.DistributedDataParallel(model, process_group=mesh.data_group)
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    for _ in range(steps):
        logits = net(images)
        loss = F.cross_entropy(logits, labels)
        acc = (logits.argmax(-1) == labels).float().mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    got = {"loss": loss.detach(), "acc": acc}
    if mesh is not None:  # equal shards: the mean of the ranks' means
        got = all_reduce_mean(got, mesh.data_group)
    return model, float(got["loss"]), float(got["acc"])


def _rank(rank, nprocs, port, device_type, out):
    from dense2sparse_vit_torch.core.mesh import local_device, make_mesh, maybe_initialize_distributed

    torch.set_num_threads(1)
    maybe_initialize_distributed(f"127.0.0.1:{port}", nprocs, rank, device_type=device_type)
    dev = local_device(device_type)
    images, labels = make_synthetic_data()
    _, loss, acc = train(images.to(dev), labels.to(dev), mesh=make_mesh())
    if rank == 0:
        out.put((loss, acc))
    torch.distributed.destroy_process_group()


def main(argv=None):  # pragma: no cover - demo entry
    import torch.multiprocessing as mp

    from dense2sparse_vit_torch.core.mesh import free_port

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--nprocs", type=int, default=2)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    if args.device == "cuda" and torch.cuda.device_count() < args.nprocs:
        raise RuntimeError(f"{args.nprocs} ranks need {args.nprocs} cards (NCCL takes one a "
                           f"rank); {torch.cuda.device_count()} here. --device cpu runs on gloo")
    dev = torch.device("cuda", 0) if args.device == "cuda" else torch.device("cpu")
    images, labels = make_synthetic_data()
    _, loss1, acc1 = train(images.to(dev), labels.to(dev))
    print(f"single-process: loss={loss1:.4f} acc={acc1:.2%}")
    ctx = mp.get_context("spawn")
    out = ctx.SimpleQueue()
    mp.spawn(_rank, args=(args.nprocs, free_port(), args.device, out), nprocs=args.nprocs)
    lossn, accn = out.get()
    print(f"{args.nprocs}-process DDP: loss={lossn:.4f} acc={accn:.2%}")
    assert abs(loss1 - lossn) < 1e-3, "DDP must match single-process math"
    print("OK: data-parallel DDP matches single-process training")


if __name__ == "__main__":  # pragma: no cover
    main()
