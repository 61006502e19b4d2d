"""Port parity, op and module level: dense2sparse_vit_torch vs dense2sparse_vit_tpu.

The same inputs and weights, drawn with numpy from fixed seeds, go through
the JAX function (its Pallas kernel in interpret mode, and its plain
reference) and through the port's counterpart, which runs its plain torch
version for CPU tensors. Comparisons are in fp32 on the CPU.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dense2sparse_vit_tpu.nn.predictor import PredictorLG as JaxPredictorLG
from dense2sparse_vit_tpu.ops.pallas.block import _ref_block
from dense2sparse_vit_tpu.ops.pallas.block import (
    fused_transformer_block as jax_fused_block,
)
from dense2sparse_vit_tpu.ops.pallas.gather import (
    fused_gather_tokens as jax_fused_gather,
)
from dense2sparse_vit_tpu.ops.pallas.predictor import (
    fused_predictor_lg as jax_fused_predictor,
)
from dense2sparse_vit_tpu.ops.topk import topk_keep_indices as jax_topk

from dense2sparse_vit_torch.nn.layers import Block
from dense2sparse_vit_torch.nn.predictor import PredictorLG
from dense2sparse_vit_torch.ops.gather import fused_gather_tokens
from dense2sparse_vit_torch.ops.predictor import (
    predictor_lg_reference,
    predictor_lg_split_reference,
)
from dense2sparse_vit_torch.ops.topk import topk_keep_indices
from dense2sparse_vit_torch.utils.convert import state_dict_from_jax
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def random_like_tree(tree, seed):
    """A copy of a flax param tree with every leaf redrawn from numpy:
    LayerNorm scales near 1, biases small, kernels ~N(0, 1/fan_in), so that
    activations stay O(1), attention logits stay far inside the +-30 range
    of the TPU inference kernel, and predictor scores are well separated."""
    rng = np.random.default_rng(seed)

    def walk(node, name):
        if hasattr(node, "items"):
            return {k: walk(v, k) for k, v in node.items()}
        shape = np.shape(node)
        if name == "scale":
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name == "bias":
            v = 0.1 * rng.standard_normal(shape)
        elif name == "kernel":
            v = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        else:  # cls_token, pos_embed
            v = 0.5 * rng.standard_normal(shape)
        return v.astype(np.float32)

    return walk(tree, None)


def load_numpy_state(module, sd):
    """Load a numpy state_dict into a torch module, strictly."""
    module.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    return module


class TestTopk:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_ties_break_by_lowest_index(self, dtype):
        # scores on a 4-value grid: every row has many exact ties
        scores = np.random.default_rng(1).integers(0, 4, (3, 20)) / 4.0
        k = 7
        want_kept, want_dropped = jax_topk(jnp.asarray(scores, dtype), k)
        kept, dropped = topk_keep_indices(
            torch.tensor(scores, dtype=getattr(torch, dtype)), k
        )
        np.testing.assert_array_equal(kept.numpy(), np.asarray(want_kept))
        np.testing.assert_array_equal(dropped.numpy(), np.asarray(want_dropped))


class TestGather:
    def test_matches_pallas_kernel_bit_exactly(self):
        rng = np.random.default_rng(2)
        x = rng.standard_normal((2, 13, 16)).astype(np.float32)
        idx = rng.integers(0, 13, (2, 9))
        idx[0, 3], idx[1, 0], idx[1, 8] = -1, 13, 40  # out of range: zero rows
        want = jax_fused_gather(jnp.asarray(x), jnp.asarray(idx, jnp.int32), 8, True)
        got = fused_gather_tokens(torch.from_numpy(x), torch.from_numpy(idx))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert not got[0, 3].any() and not got[1, 0].any()

    def test_in_range_equals_plain_gather(self):
        rng = np.random.default_rng(3)
        x = torch.from_numpy(rng.standard_normal((3, 11, 8)).astype(np.float32))
        idx = torch.from_numpy(rng.integers(0, 11, (3, 5)))
        want = torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[2]))
        torch.testing.assert_close(fused_gather_tokens(x, idx), want, rtol=0, atol=0)


def _block_params(c, hidden, seed):
    rng = np.random.default_rng(seed)

    def n(*shape, s=1.0):
        return (s * rng.standard_normal(shape)).astype(np.float32)

    return {
        "ln1_scale": 1 + n(c, s=0.1), "ln1_bias": n(c, s=0.1),
        "wqkv": n(c, 3 * c, s=c ** -0.5), "bqkv": n(3 * c, s=0.1),
        "wproj": n(c, c, s=c ** -0.5), "bproj": n(c, s=0.1),
        "ln2_scale": 1 + n(c, s=0.1), "ln2_bias": n(c, s=0.1),
        "w1": n(c, hidden, s=c ** -0.5), "b1": n(hidden, s=0.1),
        "w2": n(hidden, c, s=hidden ** -0.5), "b2": n(c, s=0.1),
    }


def _port_block_state(p):
    """JAX fused-block params (kernels (in, out)) -> port Block state_dict."""
    names = {
        "ln1_scale": "norm1.weight", "ln1_bias": "norm1.bias",
        "wqkv": "attn.qkv.weight", "bqkv": "attn.qkv.bias",
        "wproj": "attn.proj.weight", "bproj": "attn.proj.bias",
        "ln2_scale": "norm2.weight", "ln2_bias": "norm2.bias",
        "w1": "mlp.fc1.weight", "b1": "mlp.fc1.bias",
        "w2": "mlp.fc2.weight", "b2": "mlp.fc2.bias",
    }
    return {names[k]: np.array(v.T if v.ndim == 2 else v) for k, v in p.items()}


class TestBlock:
    # B=2, N=13 (not a multiple of the TPU kernel's 16-token tile), C=64,
    # H=2. Tolerance 2e-4: the TPU kernel folds LayerNorm into the weights,
    # which reorders fp32 sums.
    B, N, C, H = 2, 13, 64, 2

    @pytest.mark.parametrize("use_fused", [False, True])
    def test_matches_pallas_kernel_and_reference(self, use_fused):
        p = _block_params(self.C, 4 * self.C, seed=4)
        x = np.random.default_rng(5).standard_normal(
            (self.B, self.N, self.C)).astype(np.float32)
        want_kernel = np.asarray(jax_fused_block(
            jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, self.H,
            interpret=True,
        ))
        want_ref = np.asarray(_ref_block(
            jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()}, self.H,
            None, None, 1e-6,
        ))
        blk = load_numpy_state(
            Block(self.C, self.H, use_fused=use_fused), _port_block_state(p)
        ).eval()
        with torch.no_grad():
            got = blk(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want_kernel, atol=2e-4, rtol=2e-4)
        np.testing.assert_allclose(got, want_ref, atol=2e-4, rtol=2e-4)

    def test_fused_block_trains_on_cpu_through_the_plain_version(self):
        """Train mode takes the same dispatch as eval; on the CPU the wrapper
        runs the differentiable plain version, so gradients flow."""
        p = _block_params(self.C, 4 * self.C, seed=4)
        blk = load_numpy_state(
            Block(self.C, self.H, use_fused=True), _port_block_state(p))
        x = torch.from_numpy(np.random.default_rng(5).standard_normal(
            (self.B, self.N, self.C)).astype(np.float32))
        with torch.no_grad():
            want = blk.eval()(x)
        got = blk.train()(x)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        got.sum().backward()
        assert blk.attn.qkv.weight.grad is not None

    def test_fused_block_with_drop_path_refuses_to_train(self):
        """Without a generator to draw its DropPath scales from, a training
        block with drop_path > 0 refuses; with one it trains, and eval mode
        needs none."""
        blk = Block(self.C, self.H, drop_path=0.1, use_fused=True).train()
        with pytest.raises(ValueError, match="Generator"):
            blk(torch.zeros((self.B, self.N, self.C)))
        out = blk(torch.zeros((self.B, self.N, self.C)), generator=torch.Generator())
        assert out.shape == (self.B, self.N, self.C)
        assert blk.eval()(torch.zeros((self.B, self.N, self.C))).shape == (
            self.B, self.N, self.C)


class TestPredictor:
    # N=13, D=64; tolerance 1e-4 (fp32, LayerNorm folding in the TPU kernel)
    B, N, D = 2, 13, 64

    def _predictor(self, small, n, offset=0.0):
        """Inputs drawn with numpy, the flax module and its weights (the
        first unit's bias shifted by `offset`), the JAX module's scores and
        the Pallas kernel's (interpret mode), and the port's module carrying
        the same weights (`state_dict_from_jax`)."""
        x = np.random.default_rng(6).standard_normal(
            (self.B, n, self.D)).astype(np.float32)
        mod = JaxPredictorLG(embed_dim=self.D, small_predictor=small)
        params = random_like_tree(
            jax.eval_shape(mod.init, jax.random.PRNGKey(7), jnp.asarray(x))["params"],
            seed=8,
        )
        params["in_0"]["dense"]["bias"] = params["in_0"]["dense"]["bias"] + np.float32(offset)
        want_scores, want_probs = mod.apply({"params": params}, jnp.asarray(x))
        want_kernel = jax_fused_predictor(
            jnp.asarray(x), params, act="gelu" if small else "relu",
            interpret=True,
        )
        sd = state_dict_from_jax({"score_predictor_0": params})
        sd = {k[len("score_predictor.0."):]: v for k, v in sd.items()}
        return x, want_scores, want_probs, want_kernel, sd

    @pytest.mark.parametrize("small", [True, False])
    @pytest.mark.parametrize("use_fused", [False, True])
    def test_matches_flax_module_and_pallas_kernel(self, small, use_fused):
        x, want_scores, want_probs, want_kernel, sd = self._predictor(small, self.N)
        port = load_numpy_state(
            PredictorLG(self.D, small_predictor=small, use_fused=use_fused), sd
        ).eval()
        with torch.no_grad():
            scores, probs = port(torch.from_numpy(x))
        np.testing.assert_allclose(
            scores.numpy(), np.asarray(want_scores), atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(
            scores.numpy(), np.asarray(want_kernel), atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(
            probs.numpy(), np.asarray(want_probs), atol=1e-5, rtol=1e-4)

    @pytest.mark.parametrize("small", [True, False])
    @pytest.mark.parametrize("n", [13, 29])
    def test_split_form_matches_flax_module_and_pallas_kernel(self, small, n):
        """The algebra of the CUDA kernel's tail (out_0 split into a local
        product and a per-sample rank-1 global term, the concat row's
        statistics combined from the two halves) gives the flax module's and
        the TPU kernel's scores at ragged N."""
        x, want_scores, _, want_kernel, sd = self._predictor(small, n)
        port = load_numpy_state(PredictorLG(self.D, small_predictor=small), sd).eval()
        with torch.no_grad():
            got = predictor_lg_split_reference(
                torch.from_numpy(x), port.kernel_weights(torch.float32)).numpy()
        np.testing.assert_allclose(got, np.asarray(want_scores), atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(got, np.asarray(want_kernel), atol=1e-4, rtol=1e-4)

    def test_split_form_exact_where_the_folded_form_cancels(self):
        """A head whose outputs sit near 300 with a spread near 1 (|mean| >>
        std in every concat row). Against the plain version in float64 (the
        function's true values), the split form in fp32, which normalises
        the local half about the row's own mean and takes the pooled half
        about its own, stays within 1e-4 of the scores' scale; the TPU
        kernel's folded form (the one-pass variance E[h^2] - mu^2, the
        LayerNorm folded into the weights) misses by more than ten times
        that."""
        x, _, _, want_kernel, sd = self._predictor(True, self.N, offset=300.0)
        port = load_numpy_state(PredictorLG(self.D, small_predictor=True), sd).eval()
        with torch.no_grad():
            got = predictor_lg_split_reference(
                torch.from_numpy(x), port.kernel_weights(torch.float32)).numpy()
            port.double()
            truth = predictor_lg_reference(
                torch.from_numpy(x).double(), port.kernel_weights(torch.float64)).numpy()
        tol = 1e-4 * np.abs(truth).max()
        assert np.abs(got - truth).max() <= tol
        assert np.abs(np.asarray(want_kernel, np.float64) - truth).max() > 10 * tol

    # a split width c = 8 mod 16 (c / 2 = 20 and 12) with an output unit
    # after it, and the split after the last unit
    @pytest.mark.parametrize("d,widths,n_in", [
        (40, (40, 24, 16), 1), (48, (24, 32, 8), 1), (40, (40, 24), 2)])
    def test_split_form_at_a_split_inside_a_vector_or_after_the_last_unit(
            self, d, widths, n_in):
        """The split form against the plain version in float64 at shapes no
        model builds, which the CUDA kernel takes: weights and inputs drawn
        with numpy, tolerance 1e-4 of the scores' scale."""
        rng = np.random.default_rng(len(widths) * d)

        def unit(c_in, c_out):
            return [torch.from_numpy(a) for a in (
                1 + 0.1 * rng.standard_normal(c_in), 0.1 * rng.standard_normal(c_in),
                rng.standard_normal((c_out, c_in)) / c_in ** 0.5,
                0.1 * rng.standard_normal(c_out))]

        units = [unit(a, b) for a, b in zip((d, *widths[:-1]), widths)]
        final = unit(widths[-1], 1)
        x = torch.from_numpy(rng.standard_normal((self.B, self.N, d)))

        def weights(dt):
            return {"units": [tuple(t.to(dt) for t in u) for u in units], "n_in": n_in,
                    "final": tuple(t.to(dt) for t in final), "act": "gelu"}

        got = predictor_lg_split_reference(x.float(), weights(torch.float32))
        truth = predictor_lg_reference(x, weights(torch.float64))
        assert (got.double() - truth).abs().max() <= 1e-4 * truth.abs().max()


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import dense2sparse_vit_torch, dense2sparse_vit_torch.models, "
        "dense2sparse_vit_torch.ops, dense2sparse_vit_torch.nn, "
        "dense2sparse_vit_torch.utils.convert, dense2sparse_vit_torch.losses, "
        "dense2sparse_vit_torch.train, dense2sparse_vit_torch.utils.profile_train, "
        "dense2sparse_vit_torch.utils.profile_forward, dense2sparse_vit_torch.ops.gumbel, "
        "dense2sparse_vit_torch.ops.masked_softmax, dense2sparse_vit_torch.losses.distill, "
        "dense2sparse_vit_torch.models.dynamic_vit_default, dense2sparse_vit_torch.ops.quant, "
        "dense2sparse_vit_torch.utils.export, dense2sparse_vit_torch.utils.serving, "
        "dense2sparse_vit_torch.ops.attention, dense2sparse_vit_torch.ops.mlp, "
        "dense2sparse_vit_torch.nn.t2t, dense2sparse_vit_torch.models.t2t, "
        "dense2sparse_vit_torch.scripts, dense2sparse_vit_torch.scripts.attn_variants, "
        "dense2sparse_vit_torch.scripts.kernel_sweep, dense2sparse_vit_torch.utils.profiling, "
        "dense2sparse_vit_torch.ops.gemm, dense2sparse_vit_torch.ops.norm, "
        "dense2sparse_vit_torch.scripts.checkout_ab, dense2sparse_vit_torch.cli, "
        "dense2sparse_vit_torch.data, dense2sparse_vit_torch.data.split, "
        "dense2sparse_vit_torch.data.augment, dense2sparse_vit_torch.data.pipeline, "
        "dense2sparse_vit_torch.data.mixup, dense2sparse_vit_torch.train.loop, "
        "dense2sparse_vit_torch.train.teacher_cache, dense2sparse_vit_torch.train.schedule, "
        "dense2sparse_vit_torch.utils.checkpoint, dense2sparse_vit_torch.utils.logging, "
        "dense2sparse_vit_torch.ops.perturbed_topk, dense2sparse_vit_torch.nn.predictor, "
        "dense2sparse_vit_torch.train.train_step, dense2sparse_vit_torch.train.optimizer, "
        "dense2sparse_vit_torch.models.registry, dense2sparse_vit_torch.models.deit, "
        "dense2sparse_vit_torch.models.deit_heads, dense2sparse_vit_torch.models.dino, "
        "dense2sparse_vit_torch.models.tnt, dense2sparse_vit_torch.models.resnet, "
        "dense2sparse_vit_torch.core.mesh, dense2sparse_vit_torch.parallel, "
        "dense2sparse_vit_torch.parallel.tensor_parallel, "
        "dense2sparse_vit_torch.experiments.spmd_hello_world, "
        "dense2sparse_vit_torch.scripts.dryrun_multichip, dense2sparse_vit_torch.viz, "
        "dense2sparse_vit_torch.viz.attention_segmentation, dense2sparse_vit_torch.viz.hooks, "
        "dense2sparse_vit_torch.native, dense2sparse_vit_torch.native.normalize, "
        "dense2sparse_vit_torch.utils.reference_loader, "
        "dense2sparse_vit_torch.experiments.common, "
        "dense2sparse_vit_torch.experiments.eval_imagenet, "
        "dense2sparse_vit_torch.experiments.display_patch_drop, "
        "dense2sparse_vit_torch.experiments.optimized_mask, "
        "dense2sparse_vit_torch.experiments.parity_report\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith("
        "('jax.', 'flax', 'dense2sparse_vit_tpu')))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """Without a CUDA device, and without the package beside it, the script
    exits non-zero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the script would run for real")
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:
        cwd = str(tmp_path)
        with open(script) as src, open(tmp_path / "chip_smoke.py", "w") as dst:
            dst.write(src.read())
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
