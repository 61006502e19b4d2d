"""Export and bucketed serving of the port: `utils/export.py` and
`utils/serving.py`, mirroring the JAX package's `tests/test_export.py` and
`tests/test_serving.py`.

The three students (top-k, threshold, gumbel baseline), bf16 and int8, at
depth 2 and C=128 on the CPU, where every d2s:: op runs its plain version:
an artifact computes the live eval forward's ops on the same weights, so its
logits equal the live model's bit for bit. One served batch is held against
the JAX package's ServingModel on the same fp32 weights.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dense2sparse_vit_tpu.core.config import ModelConfig as JaxModelConfig
from dense2sparse_vit_tpu.core.config import PruningConfig as JaxPruningConfig
from dense2sparse_vit_tpu.models.student import DiffPruningStudent as JaxStudent
from dense2sparse_vit_tpu.utils.serving import ServingModel as JaxServingModel

import dense2sparse_vit_torch.utils.export as export_module
import dense2sparse_vit_torch.utils.serving as serving
from dense2sparse_vit_torch.models import DiffPruningStudent, create_model
from dense2sparse_vit_torch.utils.convert import state_dict_from_jax
from dense2sparse_vit_torch.utils.export import export_student, load_exported
from dense2sparse_vit_torch.utils.serving import ServingModel
from test_torch_ops import load_numpy_state, random_like_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = dict(img_size=32, patch_size=8, embed_dim=128, depth=2, num_heads=2, num_classes=5)
PRUNING = dict(pruning_locs=(1,), keep_ratios=(0.5,))
STUDENTS = {
    "topk": ("dynamic_vit_small_patch16_224_student", dict(small_predictor=True)),
    "threshold": ("dynamic_vit_small_patch16_224_student",
                  dict(small_predictor=True, patch_score_threshold=0.5)),
    "gumbel": ("default_dynamic_vit_small_patch16_224_student", dict(selection="gumbel")),
}


def _student(kind="topk", quant="none", dtype="bfloat16"):
    name, kw = STUDENTS[kind]
    return create_model(name, device="cpu", generator=torch.Generator().manual_seed(7),
                        use_fused_attention=True, quant=quant, dtype=dtype, **MODEL,
                        **PRUNING, **kw).eval()


def _images(n, seed=0):
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal((n, 32, 32, 3)).astype(np.float32))


def _live(student, x):
    """The live eval forward, which (as the export's) captures no CLS rows."""
    kw = {"collect_cls_attns": False} if isinstance(student, DiffPruningStudent) else {}
    with torch.no_grad():
        return student(x.to(getattr(torch, student.cfg.dtype)), **kw).logits.float()


@pytest.mark.parametrize("kind", sorted(STUDENTS))
@pytest.mark.parametrize("quant", ["none", "int8"])
def test_symbolic_artifact_equals_the_live_student(kind, quant):
    """One symbolic-batch artifact per student, through bytes: every batch
    size gives the live logits bit for bit."""
    student = _student(kind, quant)
    fn = load_exported(export_student(student, batch_size=None))
    for b in (1, 3, 8):
        x = _images(b, seed=b)
        got = fn(x)
        assert got.dtype == torch.float32 and got.shape == (b, MODEL["num_classes"])
        assert torch.equal(got, _live(student, x)), (kind, quant, b)


def test_fixed_batch_artifact_through_a_file(tmp_path):
    student = _student(quant="int8")
    path = tmp_path / "student.pt2"
    path.write_bytes(export_student(student, batch_size=4))
    x = _images(4)
    assert torch.equal(load_exported(str(path))(x), _live(student, x))


@pytest.fixture(scope="module")
def bucketed():
    student = _student(quant="int8")
    return student, ServingModel.export(student, buckets=(2, 4), try_symbolic=False)


class TestBucketedDispatch:
    @pytest.mark.parametrize("n", range(1, 9))  # ragged, up to twice the largest bucket
    def test_any_batch_size_matches_live(self, bucketed, n):
        student, sm = bucketed
        assert not sm.symbolic and sm.symbolic_error is None
        x = _images(n, seed=n)
        assert torch.equal(sm(x), _live(student, x))

    def test_bucket_choice(self, bucketed):
        _, sm = bucketed
        assert sm.buckets == (2, 4)
        assert [sm._bucket_for(n) for n in (1, 2, 3, 4, 5)] == [2, 2, 4, 4, 4]

    def test_padding_rows_do_not_leak(self, bucketed):
        """The same rows padded into different buckets give the same logits:
        the selection is per sample and zero rows cannot bleed in."""
        _, sm = bucketed
        x = _images(2)
        torch.testing.assert_close(sm(x), sm(torch.cat([x, x[:1]]))[:2], rtol=0, atol=0)

    def test_empty_batch_raises(self, bucketed):
        with pytest.raises(ValueError, match="empty"):
            bucketed[1](torch.zeros((0, 32, 32, 3)))


def test_save_load_round_trips(tmp_path, bucketed):
    student, sm = bucketed
    sm.save(str(tmp_path / "buckets"))
    manifest = json.loads((tmp_path / "buckets" / "manifest.json").read_text())
    assert manifest == {"buckets": [2, 4], "symbolic": False}
    loaded = ServingModel.load(str(tmp_path / "buckets"))
    assert loaded.buckets == (2, 4) and not loaded.symbolic
    x = _images(3)
    assert torch.equal(loaded(x), _live(student, x))

    sym = ServingModel.export(student)
    assert sym.symbolic and sym.buckets == ()
    sym.save(str(tmp_path / "symbolic"))
    loaded = ServingModel.load(str(tmp_path / "symbolic"))
    assert loaded.symbolic
    x = _images(7)
    assert torch.equal(loaded(x), _live(student, x))


def test_symbolic_serving_chunks_above_its_largest_batch(tmp_path, monkeypatch):
    """A symbolic artifact takes batches up to `utils.export.MAX_BATCH` (4
    here): larger ones are served in chunks of that size, equal to the live
    model bit for bit, and a loaded model reads the size from its manifest."""
    monkeypatch.setattr(export_module, "MAX_BATCH", 4)
    student = _student()
    sm = ServingModel.export(student)
    assert sm.symbolic and sm.max_batch == 4
    sm.save(str(tmp_path))
    assert json.loads((tmp_path / "manifest.json").read_text())["max_batch"] == 4
    monkeypatch.setattr(export_module, "MAX_BATCH", 4096)
    loaded = ServingModel.load(str(tmp_path))
    assert loaded.max_batch == 4
    for n in (5, 9):
        x = _images(n, seed=n)
        want = _live(student, x)
        assert torch.equal(sm(x), want) and torch.equal(loaded(x), want), n


def test_symbolic_failure_falls_back_to_buckets_and_says_so(tmp_path, monkeypatch):
    student = _student()
    real = serving.export_student

    def refuse_symbolic(student, batch_size=None, **kw):
        if batch_size is None:
            raise RuntimeError("no symbolic batch here")
        return real(student, batch_size=batch_size, **kw)

    monkeypatch.setattr(serving, "export_student", refuse_symbolic)
    with pytest.warns(UserWarning, match="symbolic-batch export failed"):
        sm = ServingModel.export(student, buckets=(2,))
    assert not sm.symbolic and "no symbolic batch here" in sm.symbolic_error
    sm.save(str(tmp_path))
    loaded = ServingModel.load(str(tmp_path))
    assert "no symbolic batch here" in loaded.symbolic_error
    x = _images(3)
    assert torch.equal(loaded(x), _live(student, x))


def test_loading_needs_no_model_code(tmp_path, bucketed):
    """A fresh process loads the saved artifacts and serves them without
    ever importing dense2sparse_vit_torch.models (or JAX)."""
    student, sm = bucketed
    sm.save(str(tmp_path / "art"))
    x = _images(5)
    torch.save(x, tmp_path / "x.pt")
    code = (
        "import sys, torch\n"
        "from dense2sparse_vit_torch.utils.serving import ServingModel\n"
        f"sm = ServingModel.load({str(tmp_path / 'art')!r})\n"
        f"torch.save(sm(torch.load({str(tmp_path / 'x.pt')!r})), {str(tmp_path / 'y.pt')!r})\n"
        "bad = sorted(m for m in sys.modules if m.startswith('dense2sparse_vit_torch.models')"
        " or m == 'jax' or m.startswith('dense2sparse_vit_tpu'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=300)
    assert torch.equal(torch.load(tmp_path / "y.pt"), _live(student, x))


def test_served_batch_matches_the_jax_serving_model():
    """The JAX ServingModel and the port's on the same fp32 weights (the
    JAX student without its kernels), one ragged batch of 3 through a
    bucket of 4: logits within 1e-4 (fp32, different summation orders)."""
    jcfg = JaxModelConfig(**MODEL)
    jstudent = JaxStudent(cfg=jcfg, pruning=JaxPruningConfig(small_predictor=True, **PRUNING))
    x = _images(3, seed=9)
    shapes = jax.eval_shape(jstudent.init, jax.random.PRNGKey(0), jnp.asarray(x.numpy()[:1]))
    params = random_like_tree(shapes["params"], seed=61)
    want = JaxServingModel.export(jstudent, {"params": params}, buckets=(4,),
                                  try_symbolic=False)(x.numpy())
    port = load_numpy_state(_student(dtype="float32"), state_dict_from_jax(params))
    got = ServingModel.export(port, buckets=(4,), try_symbolic=False)(x)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
