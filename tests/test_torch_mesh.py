"""The port's mesh and tensor-parallel tables in one process, against the
JAX package's: `core/mesh.py`'s batch and index rules, the partition
specs over every parameter of a tiny student, the head-aligned qkv split,
the CLI's --dist-* path, and one DDP step at world size 1 (a gloo group in
this process) bit-equal to the unwrapped step. The multi-rank checks are
in tests/test_torch_distributed.py.
"""

import copy
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dense2sparse_vit_tpu.core.mesh as jax_mesh
from dense2sparse_vit_tpu.core.config import ModelConfig as JaxModelConfig
from dense2sparse_vit_tpu.core.config import PruningConfig as JaxPruningConfig
from dense2sparse_vit_tpu.models.student import DiffPruningStudent as JaxStudent
from dense2sparse_vit_tpu.parallel.tensor_parallel import (
    param_partition_spec as jax_param_partition_spec,
)

from dense2sparse_vit_torch import cli
from dense2sparse_vit_torch.core import ExperimentConfig, TrainConfig
from dense2sparse_vit_torch.core import mesh
from dense2sparse_vit_torch.models import create_model
from dense2sparse_vit_torch.parallel import (
    all_reduce_mean,
    all_reduce_sum,
    all_reduce_sums,
    ratio_over_group,
)
from dense2sparse_vit_torch.parallel.tensor_parallel import (
    REPLICATED,
    param_partition_spec,
    parallelize,
    shard_params,
)
from dense2sparse_vit_torch.train import make_optimizer, make_train_step
from dense2sparse_vit_torch.train.train_step import wrap_ddp
from dense2sparse_vit_torch.utils.convert import state_dict_from_jax
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

MODEL = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=4, num_classes=10)
PRUNING = dict(pruning_locs=(1,), keep_ratios=(0.5,), small_predictor=True)
STUDENT = "dynamic_vit_small_patch16_224_student"


def _jax_param_shapes():
    student = JaxStudent(cfg=JaxModelConfig(**MODEL), pruning=JaxPruningConfig(**PRUNING))
    return jax.eval_shape(student.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"]


def test_partition_specs_match_jax_over_the_whole_student():
    """Every parameter of the tiny port student gets JAX's spec for the same
    parameter: names through `utils.convert`'s key map (each JAX leaf a
    constant array holding its leaf number), a 2-D kernel's spec reversed
    for the torch layout (JAX P(None, 'model') is the torch weight's dim
    0)."""
    shapes = _jax_param_shapes()
    paths, leaves = zip(*jax.tree_util.tree_flatten_with_path(shapes)[0])
    ids = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(shapes), [
        np.full(leaf.shape, i, np.float32) for i, leaf in enumerate(leaves)])
    port_of = {int(np.ravel(v)[0]): k for k, v in state_dict_from_jax(ids).items()}
    student = create_model(STUDENT, device="cpu", **MODEL, **PRUNING)
    params = dict(student.named_parameters())
    assert sorted(port_of.values()) == sorted(params)
    seen = set()
    for i, (path, leaf) in enumerate(zip(paths, leaves)):
        name = port_of[i]
        want = tuple(jax_param_partition_spec(jax_mesh_path(path), leaf))
        got = param_partition_spec(name, params[name])
        if len(want) == 2:
            want = want[::-1]
        assert got == want, (name, got, want)
        seen.add(got)
    assert seen == {REPLICATED, ("model", None), ("model",), (None, "model")}


def jax_mesh_path(path) -> str:
    """JAX `tensor_parallel._path_str` of a tree path."""
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


@pytest.mark.parametrize("size", [2, 4])
def test_qkv_shards_are_head_aligned(size):
    """Each rank's qkv rows are its heads' rows of q, of k and of v: the
    shards' thirds put back together give the full weight, and each rank's
    product reshaped to its heads equals the full product's heads of that
    rank; proj splits by the same heads' columns, fc1 / fc2 contiguously."""
    rng = np.random.default_rng(3)
    c, heads, d = 64, 4, 16
    full = {
        "blocks.0.attn.qkv.weight": torch.from_numpy(rng.standard_normal((3 * c, c))),
        "blocks.0.attn.qkv.bias": torch.from_numpy(rng.standard_normal(3 * c)),
        "blocks.0.attn.proj.weight": torch.from_numpy(rng.standard_normal((c, c))),
        "blocks.0.mlp.fc1.weight": torch.from_numpy(rng.standard_normal((4 * c, c))),
        "blocks.0.mlp.fc2.weight": torch.from_numpy(rng.standard_normal((c, 4 * c))),
        "blocks.0.norm1.weight": torch.from_numpy(rng.standard_normal(c)),
    }
    shards = [shard_params(full, mesh.Mesh({"data": 1, "model": size}, 0, r))
              for r in range(size)]
    w = full["blocks.0.attn.qkv.weight"]
    thirds = [s["blocks.0.attn.qkv.weight"].chunk(3, 0) for s in shards]
    assert torch.equal(torch.cat([torch.cat([t[j] for t in thirds]) for j in range(3)]), w)
    x = torch.from_numpy(rng.standard_normal((2, 5, c)))
    want = (x @ w.T).view(2, 5, 3, heads, d)
    hl = heads // size
    for r, s in enumerate(shards):
        got = (x @ s["blocks.0.attn.qkv.weight"].T).view(2, 5, 3, hl, d)
        assert torch.equal(got, want[:, :, :, r * hl:(r + 1) * hl])
        qkv_b = s["blocks.0.attn.qkv.bias"].view(3, hl, d)
        assert torch.equal(qkv_b, full["blocks.0.attn.qkv.bias"].view(3, heads, d)[:, r * hl:(r + 1) * hl])
        assert torch.equal(s["blocks.0.attn.proj.weight"],
                           full["blocks.0.attn.proj.weight"][:, r * hl * d:(r + 1) * hl * d])
        assert torch.equal(s["blocks.0.mlp.fc1.weight"], full["blocks.0.mlp.fc1.weight"].chunk(size)[r])
        assert torch.equal(s["blocks.0.mlp.fc2.weight"],
                           full["blocks.0.mlp.fc2.weight"].chunk(size, 1)[r])
        assert s["blocks.0.norm1.weight"] is full["blocks.0.norm1.weight"]


@pytest.mark.parametrize("world", [1, 2, 3, 4, 8])
def test_batch_and_index_rules_match_jax(monkeypatch, world):
    """host_local_batch (and its refusal), process_local_indices and
    local_rows against the JAX functions, with jax.process_index /
    process_count patched to each rank of `world` processes."""
    indices = np.random.default_rng(5).permutation(37)
    for b in (8, 12, 24, 30):
        fake = types.SimpleNamespace(shape={"data": world, "model": 1})
        m = mesh.Mesh({"data": world, "model": 1})
        if b % world:
            for fn, arg in ((jax_mesh.host_local_batch, fake), (mesh.host_local_batch, m)):
                with pytest.raises(ValueError, match="not divisible"):
                    fn(b, arg)
        else:
            assert mesh.host_local_batch(b, m) == jax_mesh.host_local_batch(b, fake) == b // world
    rows = []
    for r in range(world):
        monkeypatch.setattr(jax, "process_index", lambda r=r: r)
        monkeypatch.setattr(jax, "process_count", lambda: world)
        monkeypatch.setattr(mesh, "rank", lambda r=r: r)
        monkeypatch.setattr(mesh, "world_size", lambda: world)
        want = jax_mesh.process_local_indices(indices)
        np.testing.assert_array_equal(mesh.process_local_indices(indices), want)
        np.testing.assert_array_equal(
            mesh.process_local_indices(indices, mesh.Mesh({"data": world, "model": 2}, r, 1)),
            want)
        rows.append(mesh.local_rows(np.arange(8 * world), mesh.Mesh({"data": world, "model": 1},
                                                                    r)))
    np.testing.assert_array_equal(np.concatenate(rows), np.arange(8 * world))


def test_one_process_is_a_one_by_one_mesh_and_the_helpers_are_identities(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert not mesh.distributed() and mesh.is_primary()
    assert mesh.maybe_initialize_distributed() is False
    with pytest.raises(ValueError, match="coordinator"):
        mesh.maybe_initialize_distributed(num_processes=2)
    m = mesh.make_mesh()
    assert m.shape == {"data": 1, "model": 1} and m.data_group is None and m.model_group is None
    with pytest.raises(ValueError, match="does not cover"):
        mesh.make_mesh(data=2)
    rng = np.random.default_rng(6)
    num, den = torch.tensor(rng.random()), torch.tensor(7.0)
    assert torch.equal(ratio_over_group(num, den), num / den.clamp_min(1.0))
    assert torch.equal(ratio_over_group(num, torch.tensor(0.0)), num)
    x = torch.from_numpy(rng.standard_normal(3))
    assert all_reduce_sum(x) is x
    tree = {"a": torch.tensor(1.5), "b": torch.ones(2)}
    assert all_reduce_mean(tree) == tree and all_reduce_sums(tree) == tree
    assert 0 < mesh.free_port() < 65536


def test_the_cli_parses_dist_flags_and_no_longer_rejects_them():
    argv = ["--dist-coordinator", "127.0.0.1:29500", "--dist-num-processes", "2",
            "--dist-process-id", "1", "--device", "cpu"]
    cfg, args = cli.parse_config(argv)
    assert (args.dist_coordinator, args.dist_num_processes, args.dist_process_id) == (
        "127.0.0.1:29500", 2, 1)
    assert cfg == cli.parse_config(["--device", "cpu"])[0]
    assert "torchrun" in cli.build_parser().format_help()


def test_tensor_parallelism_refuses_the_fused_block():
    """The whole-block kernels cannot hold the all-reduce after proj and fc2:
    a fused student on a model group of two is refused, naming why."""
    student = create_model(STUDENT, device="cpu", use_fused_attention=True, **MODEL, **PRUNING)
    with pytest.raises(NotImplementedError, match="all-reduce after proj"):
        parallelize(student, mesh.Mesh({"data": 1, "model": 2}))
    plain = create_model(STUDENT, device="cpu", **MODEL, **PRUNING)
    assert parallelize(plain, mesh.make_mesh()) is plain  # model = 1: as it is


@pytest.fixture
def world_of_one():
    torch.distributed.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{mesh.free_port()}",
                                         world_size=1, rank=0)
    try:
        yield mesh.make_mesh()
    finally:
        torch.distributed.destroy_process_group()


def test_a_ddp_step_at_world_one_is_bit_equal_to_the_unwrapped_step(world_of_one):
    """A process group of one rank (what the card's phase 36 runs over
    NCCL): the mesh's data group is that group, and one top-k train step of
    the student under `wrap_ddp` gives the unwrapped step's loss, metrics
    and updated parameters bit for bit."""
    assert world_of_one.shape == {"data": 1, "model": 1} and world_of_one.data_group is not None
    student = create_model(STUDENT, device="cpu", **MODEL, **PRUNING)
    twin = copy.deepcopy(student)
    teacher = create_model("dynamic_vit_small_patch16_224_teacher", device="cpu", **MODEL)
    cfg = ExperimentConfig(model=student.cfg, pruning=student.pruning,
                           train=TrainConfig(epochs=10, warmup_epochs=5))
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((4, 32, 32, 3)).astype(
        np.float32))
    y = torch.tensor([1, 2, 3, 4])
    got, want = [], []
    for model, out, wrap in ((student, got, True), (twin, want, False)):
        opt = make_optimizer(model, cfg.train, 3)
        opt.count = 18
        net = wrap_ddp(model, cfg, world_of_one) if wrap else model
        out.append(make_train_step(net, teacher, opt, cfg)(x, y, 6))
    assert got[0].keys() == want[0].keys()
    for k in got[0]:
        assert torch.equal(got[0][k], want[0][k]), k
    for (n, p), q in zip(student.named_parameters(), twin.parameters()):
        assert torch.equal(p, q), n


def test_remat_and_teacher_cls_selection_run_under_ddp(world_of_one):
    """Under `wrap_ddp`, remat recomputes inside the wrapped module
    (`StudentForward`): its step equals the unwrapped remat step bit for
    bit, and a DDP not made by `wrap_ddp` is refused. Teacher-CLS selection
    leaves its predictors without a gradient: its wrapper alone finds the
    unused parameters, and two steps run (DDP raises at the second where it
    does not)."""
    from dense2sparse_vit_torch.train.train_step import StudentForward

    teacher = create_model("dynamic_vit_small_patch16_224_teacher", device="cpu", **MODEL)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal((4, 32, 32, 3)).astype(
        np.float32))
    y = torch.tensor([1, 2, 3, 4])
    student = create_model(STUDENT, device="cpu", remat=True, drop_path_rate=0.1, **MODEL,
                           **PRUNING)
    twin = copy.deepcopy(student)
    cfg = ExperimentConfig(model=student.cfg, pruning=student.pruning,
                           train=TrainConfig(epochs=10, warmup_epochs=5))
    net = wrap_ddp(student, cfg, world_of_one)
    assert isinstance(net.module, StudentForward) and net.module.remat
    assert not net.find_unused_parameters
    got = []
    for model, wrap in ((student, net), (twin, twin)):
        opt = make_optimizer(model, cfg.train, 3)
        opt.count = 18
        gen = torch.Generator().manual_seed(5)
        got.append(make_train_step(wrap, teacher, opt, cfg)(x, y, 6, generator=gen))
    assert torch.equal(got[0]["loss"], got[1]["loss"])
    for p, q in zip(student.parameters(), twin.parameters()):
        assert torch.equal(p, q)
    bare = torch.nn.parallel.DistributedDataParallel(twin, process_group=world_of_one.data_group)
    with pytest.raises(ValueError, match="comes from wrap_ddp"):
        make_train_step(bare, teacher, make_optimizer(twin, cfg.train, 3), cfg)

    student = create_model(STUDENT, device="cpu", cls_from_teacher=True, **MODEL, **PRUNING)
    cfg = ExperimentConfig(model=student.cfg, pruning=student.pruning,
                           train=TrainConfig(epochs=10, warmup_epochs=5))
    net = wrap_ddp(student, cfg, world_of_one)
    assert net.find_unused_parameters
    step = make_train_step(net, teacher, make_optimizer(student, cfg.train, 3), cfg)
    for _ in range(2):
        assert torch.isfinite(step(x, y, 6)["loss"])
