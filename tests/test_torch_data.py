"""Port parity of the data pipeline: dense2sparse_vit_torch.data vs
dense2sparse_vit_tpu.data.

A class-per-folder set of small JPEGs written from a numpy seed; the same
images, indices and seeds go through the JAX package's functions and the
port's. The uint8 images, batches and indices must be equal exactly, fp32
outputs within 1e-6. The card-side random functions are held to JAX's
when fed JAX's own draws, which each test reproduces from the same key with
`jax.random`, as the JAX function splits it.
"""

import os

import jax
import jax.numpy as jnp
import jax.random as jr
import numpy as np
import pytest
import torch
from PIL import Image

from dense2sparse_vit_tpu.core.config import DataConfig as JaxDataConfig
from dense2sparse_vit_tpu.data import mixup as jax_mixup
from dense2sparse_vit_tpu.data import pipeline as jax_pipeline
from dense2sparse_vit_tpu.data import split as jax_split

from dense2sparse_vit_torch.core.config import DataConfig
from dense2sparse_vit_torch.data import mixup, pipeline, split
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

# small views: the eval transform resizes the short side to 36 and crops 32
VIEW = dict(eval_resize=36, eval_crop=32)


def write_folder(root, classes=3, images=7, sides=(32, 48), seed=0):
    rng = np.random.default_rng(seed)
    for c in range(classes):
        d = os.path.join(root, f"c{c}")
        os.makedirs(d)
        for i in range(images):
            h, w = (int(v) for v in rng.integers(sides[0], sides[1] + 1, 2))
            arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            Image.fromarray(arr).save(os.path.join(d, f"{i:03d}.jpg"), quality=90)
    # files the index skips: not an image, and a stray top-level file
    open(os.path.join(root, "c0", "notes.txt"), "w").close()
    open(os.path.join(root, "README"), "w").close()


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("images"))
    write_folder(root)
    return root


def _image(w, h, seed=0):
    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))


def test_image_folder_and_split_match_jax(folder):
    ours = pipeline.ImageFolder(folder)
    theirs = jax_pipeline.ImageFolder(folder)
    assert ours.classes == theirs.classes == ["c0", "c1", "c2"]
    assert ours.samples == theirs.samples and len(ours) == 21
    for seed in (0, 42):
        for a, b in zip(split.split_train_val_indices(len(ours), 0.8, seed),
                        jax_split.split_train_val_indices(len(theirs), 0.8, seed)):
            np.testing.assert_array_equal(a, b)


def test_split_imagenet_validation_set_matches_jax(folder, tmp_path):
    got = split.split_imagenet_validation_set(folder, str(tmp_path / "a" / "tr"),
                                              str(tmp_path / "a" / "va"), 0.3, seed=5)
    want = jax_split.split_imagenet_validation_set(folder, str(tmp_path / "b" / "tr"),
                                                   str(tmp_path / "b" / "va"), 0.3, seed=5)
    assert got == want
    for sub in ("tr", "va"):
        for c in ("c0", "c1", "c2"):
            assert (sorted(os.listdir(tmp_path / "a" / sub / c))
                    == sorted(os.listdir(tmp_path / "b" / sub / c)))


@pytest.mark.parametrize("size", [(40, 52), (52, 40), (36, 50), (50, 36), (36, 36)])
def test_eval_transform_is_bit_equal_to_jax(size):
    """w < h, w > h, and a short side already at eval_resize (no resize)."""
    img = _image(*size)
    got = pipeline.eval_transform(DataConfig(**VIEW), normalize=False)(img)
    want = jax_pipeline.eval_transform(JaxDataConfig(**VIEW), normalize=False)(img)
    assert got.dtype == np.uint8 and got.shape == (32, 32, 3)
    np.testing.assert_array_equal(got, want)
    got = pipeline.eval_transform(DataConfig(**VIEW))(img)
    want = jax_pipeline.eval_transform(JaxDataConfig(**VIEW))(img)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", range(8))
def test_train_transform_matches_jax_given_its_generator(seed):
    """The port's transform given default_rng(s) draws what the JAX
    transform seeded with s draws for its first image: RandomResizedCrop,
    flip and the default RandAugment bit-equal (uint8), and with normalize
    and host random erasing within 1e-6."""
    img = _image(48, 40, seed=100 + seed)
    cfg, jcfg = DataConfig(**VIEW), JaxDataConfig(**VIEW)
    got = pipeline.train_transform(cfg, as_uint8=True)(img, np.random.default_rng(seed))
    want = jax_pipeline.train_transform(jcfg, seed=seed, as_uint8=True)(img)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    cfg, jcfg = DataConfig(reprob=0.9, **VIEW), JaxDataConfig(reprob=0.9, **VIEW)
    got = pipeline.train_transform(cfg)(img, np.random.default_rng(seed))
    want = jax_pipeline.train_transform(jcfg, seed=seed)(img)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _batches(loader, epoch=None):
    return [tuple(np.asarray(v) for v in item)
            for item in (loader() if epoch is None else loader(epoch))]


LOADERS = {
    "shuffled subset, drop_last": dict(shuffle=True, seed=3, indices=list(range(2, 19))),
    "tail kept, with indices, cached": dict(drop_last=False, with_indices=True,
                                            cache_decoded=True, shuffle=True, seed=1),
    "normalized on the host": dict(normalize=True, drop_last=False),
    "a shared decoded store": dict(shared=True, cache_decoded=True, with_indices=True),
}


def ours_dataset(folder):
    return pipeline.ImageFolder(folder, pipeline.eval_transform(DataConfig(**VIEW), False))


def _loaders(folder, name):
    """The port's and the JAX package's loader for LOADERS[name]."""
    kw = dict(LOADERS[name])
    normalize = kw.pop("normalize", False)
    shared = kw.pop("shared", False)
    if shared:  # each side's own dict, filled by a first loader over it
        kw["shared_cache"] = {}
    if shared:
        pipeline.make_loader(ours_dataset(folder), 5, drop_last=False, cache_decoded=True,
                             as_uint8=True, shared_cache=kw["shared_cache"])
    ours = pipeline.make_loader(ours_dataset(folder), 4, as_uint8=not normalize,
                                normalize_cfg=DataConfig(**VIEW) if normalize else None, **kw)
    jds = jax_pipeline.ImageFolder(folder, jax_pipeline.eval_transform(JaxDataConfig(**VIEW),
                                                                       False))
    if shared:
        kw["shared_cache"] = {}
        jax_pipeline.make_loader(jds, 5, drop_last=False, cache_decoded=True, as_uint8=True,
                                 shared_cache=kw["shared_cache"])
    theirs = jax_pipeline.make_loader(jds, 4, as_uint8=not normalize,
                                      normalize_cfg=JaxDataConfig(**VIEW) if normalize else None,
                                      **kw)
    return ours, theirs, normalize


@pytest.mark.parametrize("name", sorted(LOADERS))
def test_make_loader_matches_jax_at_epochs_0_and_1(folder, name):
    """Order, drop_last, subset indices, with_indices, the decoded cache,
    uint8 or host-normalized batches: the port's loader at epochs 0 and 1
    against the JAX loader's first two epochs; without an epoch the port's
    counts its epochs, as the JAX one does."""
    ours, theirs, normalize = _loaders(folder, name)
    counting, _, _ = _loaders(folder, name)
    for epoch in (0, 1):
        got, want, counted = _batches(ours, epoch), _batches(theirs), _batches(counting)
        assert len(got) == len(want) == len(counted) > 0
        for g, w, c in zip(got, want, counted):
            assert len(g) == len(w) == (3 if LOADERS[name].get("with_indices") else 2)
            assert g[0].dtype == w[0].dtype
            if normalize:
                np.testing.assert_allclose(g[0], w[0], rtol=0, atol=1e-6)
            else:
                np.testing.assert_array_equal(g[0], w[0])
            for a, b in zip(g[1:], w[1:]):
                np.testing.assert_array_equal(a, b)
            for a, b in zip(g, c):
                np.testing.assert_array_equal(a, b)


def test_loaders_sharing_a_cache_decode_each_sample_once(folder, monkeypatch):
    ds = ours_dataset(folder)
    calls = []
    real = ds.load
    monkeypatch.setattr(ds, "load", lambda i, rng=None: calls.append(i) or real(i, rng))
    shared = {}
    a = pipeline.make_loader(ds, 5, drop_last=False, cache_decoded=True, as_uint8=True,
                             shared_cache=shared, with_indices=True)
    b = pipeline.make_loader(ds, 3, shuffle=True, cache_decoded=True, as_uint8=True,
                             shared_cache=shared)
    first = _batches(a, 0)
    calls.clear()
    second = _batches(b, 0) + _batches(a, 1)
    assert not calls  # every sample came from the shared store
    assert sum(len(x[1]) for x in first) == len(ds) and second


def test_pinned_loader_yields_torch_tensors(folder):
    loader = pipeline.make_loader(ours_dataset(folder), 4, as_uint8=True, pin_memory=True)
    xb, yb = next(iter(loader(0)))
    assert isinstance(xb, torch.Tensor) and xb.dtype == torch.uint8 and xb.shape == (4, 32, 32, 3)
    assert isinstance(yb, torch.Tensor) and yb.dtype == torch.int32


def test_a_random_transform_refuses_the_decoded_cache(folder):
    ds = pipeline.ImageFolder(folder, pipeline.train_transform(DataConfig(**VIEW), True))
    with pytest.raises(ValueError, match="deterministic"):
        pipeline.make_loader(ds, 4, cache_decoded=True, as_uint8=True)


def test_workers_give_the_batches_of_no_workers(folder):
    """Two spawned workers decode, crop, flip and RandAugment exactly what
    the loader's own thread does, epoch by epoch: each sample's generator
    is its (seed, epoch, index)'s. A second epoch draws anew."""
    ds = pipeline.ImageFolder(folder, pipeline.train_transform(DataConfig(**VIEW), True))
    serial = pipeline.make_loader(ds, 4, shuffle=True, seed=9, as_uint8=True)
    pooled = pipeline.make_loader(ds, 4, shuffle=True, seed=9, as_uint8=True, num_workers=2)
    try:
        runs = {}
        for epoch in (0, 1):
            a, b = _batches(serial, epoch), _batches(pooled, epoch)
            assert len(a) == len(b) == 5
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x[0], y[0])
                np.testing.assert_array_equal(x[1], y[1])
            runs[epoch] = a
        assert not np.array_equal(runs[0][0][0], runs[1][0][0])
        # an epoch left early, then the next one: the pool still answers in order
        it = pooled(2)
        next(it)
        it.close()
        for x, y in zip(_batches(serial, 3), _batches(pooled, 3)):
            np.testing.assert_array_equal(x[0], y[0])
    finally:
        pooled.close()


def test_a_failing_transform_reaches_the_consumer(folder):
    class Broken:
        random = False

        def __call__(self, img):
            raise RuntimeError("broken transform")

    loader = pipeline.make_loader(pipeline.ImageFolder(folder, Broken()), 4)
    with pytest.raises(RuntimeError, match="broken transform"):
        _batches(loader, 0)


# ---- the card-side functions ------------------------------------------------


def test_device_normalize_matches_jax():
    x = np.random.default_rng(3).integers(0, 256, (2, 8, 8, 3), dtype=np.uint8)
    got = pipeline.device_normalize(torch.from_numpy(x), DataConfig())
    want = jax_pipeline.device_normalize(jnp.asarray(x), JaxDataConfig())
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), jax_pipeline._normalize(x, JaxDataConfig()),
                               rtol=0, atol=1e-5)


def _jax_erasing_draws(key, shape, count):
    """The draws of JAX `device_random_erasing`, split from `key` as it does."""
    B = shape[0]
    kgate, kboxes = jr.split(key)
    boxes = []
    for i in range(count):
        kt, ka, ktop, kleft, kn = jr.split(jr.fold_in(kboxes, i), 5)
        boxes.append({
            "target": jr.uniform(kt, (B, 10), minval=0.02, maxval=1.0 / 3.0),
            "log_aspect": jr.uniform(ka, (B, 10), minval=jnp.log(0.3),
                                     maxval=jnp.log(10.0 / 3.0)),
            "top": jr.uniform(ktop, (B,)), "left": jr.uniform(kleft, (B,)),
            "noise": jr.normal(kn, shape, jnp.float32),
        })
    return {"gate": jr.uniform(kgate, (B,)), "boxes": boxes}


def _to_torch(tree):
    return jax.tree_util.tree_map(lambda v: torch.from_numpy(np.array(v)), tree)


@pytest.mark.parametrize("count,prob", [(1, 0.25), (2, 0.7), (1, 1.0)])
def test_random_erasing_matches_jax_on_its_draws(count, prob):
    shape = (16, 12, 10, 3)
    x = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    key = jr.PRNGKey(11 + count)
    jcfg = JaxDataConfig(reprob=prob, recount=count)
    want = np.asarray(jax_pipeline.device_random_erasing(key, jnp.asarray(x), jcfg))
    draws = _to_torch(_jax_erasing_draws(key, shape, count))
    got = pipeline.erase_with_draws(torch.from_numpy(x), draws, prob).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    erased = (want != x).any(axis=(1, 2, 3))
    assert erased.any() and (prob == 1.0 or not erased.all())


def test_device_random_erasing_draws_from_its_generator():
    cfg = DataConfig(reprob=1.0, recount=2)
    x = torch.zeros((4, 12, 10, 3))
    a = pipeline.device_random_erasing(x, cfg, torch.Generator().manual_seed(1))
    b = pipeline.device_random_erasing(x, cfg, torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and (a != 0).any()
    assert pipeline.device_random_erasing(x, DataConfig(reprob=0.0), None) is x


def _jax_mixup_draws(key, B, H, W, mixup_alpha, cutmix_alpha, cutmix_minmax, mode):
    """The draws of JAX `mixup_cutmix_batch`, split from `key` as it does."""
    k_apply, k_switch, k_lam_m, k_lam_c, k_box = jr.split(key, 5)
    per = () if mode == "batch" else (B,)
    d = {
        "apply_u": jr.uniform(k_apply, per),
        "switch_u": jr.uniform(k_switch, per),
        "lam_m": jr.beta(k_lam_m, mixup_alpha, mixup_alpha, per) if mixup_alpha > 0
        else jnp.ones(per),
        "lam_c": jr.beta(k_lam_c, cutmix_alpha, cutmix_alpha, per) if cutmix_alpha > 0
        else jnp.ones(per),
    }
    if cutmix_minmax is not None:
        mn, mx = cutmix_minmax
        kh, kw, ky, kx = jr.split(k_box, 4)
        d.update(cut_h=jr.randint(kh, per, int(H * mn), int(H * mx) + 1),
                 cut_w=jr.randint(kw, per, int(W * mn), int(W * mx) + 1),
                 uy=jr.uniform(ky, per), ux=jr.uniform(kx, per))
    else:
        ky, kx = jr.split(k_box)
        d.update(cy=jr.randint(ky, per, 0, H), cx=jr.randint(kx, per, 0, W))
    return d


MIX_CASES = {
    "default": dict(),
    "cutmix_minmax": dict(cutmix_minmax=(0.3, 0.7)),
    "prob 0.5": dict(prob=0.5),
    "mixup only": dict(cutmix_alpha=0.0),
    "cutmix only": dict(mixup_alpha=0.0),
    "minmax alone": dict(mixup_alpha=0.0, cutmix_alpha=0.0, cutmix_minmax=(0.2, 0.6)),
}


@pytest.mark.parametrize("mode", ["batch", "elem", "pair"])
@pytest.mark.parametrize("case", sorted(MIX_CASES))
def test_mixup_cutmix_matches_jax_on_its_draws(mode, case):
    B, H, W, C, K = 6, 12, 10, 3, 7
    kw = {**dict(mixup_alpha=0.8, cutmix_alpha=1.0, cutmix_minmax=None, prob=1.0,
                 switch_prob=0.5, smoothing=0.1), **MIX_CASES[case]}
    rng = np.random.default_rng(6)
    images = rng.standard_normal((B, H, W, C)).astype(np.float32)
    labels = rng.integers(0, K, B)
    for seed in range(3):
        key = jr.PRNGKey(20 + seed)
        want_x, want_t = jax_mixup.mixup_cutmix_batch(
            key, jnp.asarray(images), jnp.asarray(labels), K, mode=mode, **kw)
        draws = _to_torch(_jax_mixup_draws(key, B, H, W, kw["mixup_alpha"], kw["cutmix_alpha"],
                                           kw["cutmix_minmax"], mode))
        got_x, got_t = mixup.mix_with_draws(torch.from_numpy(images), torch.from_numpy(labels),
                                            draws, K, mode=mode, **kw)
        np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=0, atol=1e-6)
        np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), rtol=0, atol=1e-6)
        np.testing.assert_allclose(got_t.sum(-1).numpy(), 1.0, rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode", ["batch", "elem", "pair"])
def test_mixup_draws_from_its_generator(mode):
    m = mixup.Mixup(cutmix_minmax=None, mode=mode, num_classes=5)
    x = torch.randn((4, 8, 8, 3), generator=torch.Generator().manual_seed(0))
    y = torch.tensor([0, 1, 2, 3])
    a = m(torch.Generator().manual_seed(2), x, y)
    b = m(torch.Generator().manual_seed(2), x, y)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert a[0].shape == x.shape and a[1].shape == (4, 5) and m.active
    assert not mixup.Mixup(mixup_alpha=0.0, cutmix_alpha=0.0).active
    with pytest.raises(ValueError, match="mode"):
        mixup.Mixup(mode="rows")
