"""The port's train path against the JAX reference: ``model.loss_fn`` and
its gradients.

Every config the port registers (``upmem_gemv`` is not a model) at its
smoke size in float32, the reference's own seeded parameters brought
across with ``params_from_numpy`` and every norm scale, bias, cross gate,
Mamba ``D`` and ``conv_b`` drawn off its init (so that a dropped term, or
llama-vision's closed gate, would show).  ``loss_fn``'s value and metrics
(``ce``, ``aux``, ``z``, ``tokens``) within float32 rounding; the gradient
leaf by leaf, mapped to the reference's layout by ``params_to_numpy``,
for the dense, MLA + MoE (deepseek's dense prefix layer included),
window + MoE, Mamba, hybrid and encoder-decoder families, with remat on
as in the reference's train step, and once in bf16.  Labels include
masked positions (-1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES as REF_ARCHS
from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import model as ref_model
from repro.sharding import partitioning as P
from repro_torch import convert
from repro_torch.configs import ARCH_NAMES, get_smoke_config
from repro_torch.models import model as model_lib
from repro_torch.train import trainstep

jax.config.update("jax_platform_name", "cpu")

VOCAB = 128
B, S = 2, 24
#: loss and metrics: float32 sums in another order
LOSS_RTOL = 1e-5
#: a gradient leaf against the reference's, relative to the leaf's largest
#: element (float32 sums of B·S terms in another order; the Mamba scan's
#: passes differ from lax.associative_scan's)
GRAD_RTOL = 1e-4
#: bf16: each matmul rounds its output to 2^-8; relative to the leaf's max
BF16_GRAD_RTOL = 0.1
BF16_LOSS_RTOL = 2e-2

#: leaves initialised to ones or zeros, drawn off them
_OFF_INIT = {"scale", "bias", "q_norm", "k_norm", "kv_norm", "bq", "bk", "bv", "gate", "D",
             "conv_b"}

GRAD_ARCHS = ["qwen3-1.7b", "deepseek-v2-lite-16b", "mixtral-8x7b", "falcon-mamba-7b",
              "jamba-1.5-large-398b", "seamless-m4t-medium"]


def cfgs(arch, dtype="float32"):
    return (ref_smoke_config(arch).scaled(dtype=getattr(jnp, dtype), vocab_size=VOCAB),
            get_smoke_config(arch).scaled(dtype=getattr(torch, dtype), vocab_size=VOCAB))


_CACHE: dict = {}


def ref_params(arch, dtype="float32"):
    key = "params", arch, dtype
    if key not in _CACHE:
        _CACHE[key] = _draw(arch, dtype)
    return _CACHE[key]


def _draw(arch, dtype):
    rc, _ = cfgs(arch, dtype)
    params = P.materialize(ref_model.specs(rc, 1), jax.random.PRNGKey(0))
    rng = np.random.default_rng(11)

    def leaf(path, a):
        a = np.asarray(a)
        if path[-1].key in _OFF_INIT:
            base = 0.5 if path[-1].key == "gate" else 0.0
            return jnp.asarray((a.astype(np.float32) + base
                                + rng.normal(0.0, 0.3, a.shape)).astype(a.dtype))
        return jnp.asarray(a)

    return jax.tree_util.tree_map_with_path(leaf, params)


def batch_for(rc, seed=0):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, VOCAB, (B, S)).astype(np.int32)
    labels[0, :3] = -1
    labels[1, -5:] = -1
    batch = {"tokens": rng.integers(0, VOCAB, (B, S)).astype(np.int32), "labels": labels}
    if rc.is_enc_dec:
        batch["enc_embeds"] = rng.normal(size=(B, rc.encoder_tokens, rc.d_model)).astype(
            np.float32)
    elif rc.family == "vlm":
        batch["ctx_embeds"] = rng.normal(size=(B, rc.encoder_tokens, rc.d_model)).astype(
            np.float32)
    return batch


def _port(arch, dtype, params):
    _, pc = cfgs(arch, dtype)
    return convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, params), pc, "cpu")


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_every_ported_config_has_a_reference():
    assert set(ARCH_NAMES) == set(REF_ARCHS) - {"upmem_gemv"}


def reference(arch, dtype="float32"):
    """The reference's loss, metrics and (for :data:`GRAD_ARCHS` and bf16)
    gradients on :func:`batch_for`'s batch, jitted once per test process:
    ``jax.value_and_grad`` with remat as in the reference's train step."""
    key = "ref", arch, dtype
    if key not in _CACHE:
        rc, _ = cfgs(arch, dtype)
        batch = {k: jnp.asarray(v) for k, v in batch_for(rc).items()}
        if arch in GRAD_ARCHS or dtype != "float32":
            fn = jax.jit(jax.value_and_grad(
                lambda p, b: ref_model.loss_fn(p, b, rc, remat=True), has_aux=True))
            (loss, metrics), grads = fn(ref_params(arch, dtype), batch)
        else:
            loss, metrics = jax.jit(lambda p, b: ref_model.loss_fn(p, b, rc))(
                ref_params(arch, dtype), batch)
            grads = None
        _CACHE[key] = loss, metrics, grads
    return _CACHE[key]


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_loss_matches_reference(arch):
    rc, pc = cfgs(arch)
    params = ref_params(arch)
    batch = batch_for(rc)
    want, want_m, _ = reference(arch)
    with torch.no_grad():
        got, got_m = model_lib.loss_fn(_port(arch, "float32", params), _torch_batch(batch), pc)
    assert got.item() == pytest.approx(float(want), rel=LOSS_RTOL)
    assert set(got_m) == set(want_m)
    for k in want_m:
        assert got_m[k].item() == pytest.approx(float(want_m[k]), rel=LOSS_RTOL, abs=1e-6), k
    assert got_m["tokens"].item() == B * S - 8
    if pc.n_experts:
        assert got_m["aux"].item() > 0


def _grads(arch, dtype):
    rc, pc = cfgs(arch, dtype)
    params = ref_params(arch, dtype)
    batch = batch_for(rc)
    want, _, want_g = reference(arch, dtype)
    got, _, got_g = trainstep.value_and_grad(_port(arch, dtype, params), _torch_batch(batch),
                                             pc, trainstep.TrainStepConfig(remat=True))
    return float(want), got.item(), want_g, convert.params_to_numpy(got_g, pc)


def _check_grads(want_g, got_g, rtol):
    want_leaves = jax.tree_util.tree_leaves_with_path(want_g)
    got_leaves = jax.tree_util.tree_leaves(got_g)
    assert jax.tree_util.tree_structure(got_g) == jax.tree_util.tree_structure(want_g)
    for (path, want), got in zip(want_leaves, got_leaves):
        want = np.asarray(want).astype(np.float32)
        got = np.asarray(got).astype(np.float32)
        assert got.shape == want.shape, jax.tree_util.keystr(path)
        scale = np.abs(want).max()
        if scale == 0:  # a leaf the loss does not reach (seamless's cross gates)
            assert not got.any(), jax.tree_util.keystr(path)
            continue
        err = np.abs(got - want).max() / scale
        assert err <= rtol, f"{jax.tree_util.keystr(path)}: {err:.2e}"


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_gradients_match_reference_leaf_by_leaf(arch):
    want, got, want_g, got_g = _grads(arch, "float32")
    assert got == pytest.approx(want, rel=LOSS_RTOL)
    _check_grads(want_g, got_g, GRAD_RTOL)


def test_bf16_gradients_close_to_reference():
    want, got, want_g, got_g = _grads("qwen3-1.7b", "bfloat16")
    assert got == pytest.approx(want, rel=BF16_LOSS_RTOL)
    _check_grads(want_g, got_g, BF16_GRAD_RTOL)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "deepseek-v2-lite-16b"])
def test_remat_changes_no_bit(arch):
    """Recomputing each layer in the backward pass gives the same loss and
    gradients, bit for bit (the CPU recomputes in the same order)."""
    rc, pc = cfgs(arch)
    params = _port(arch, "float32", ref_params(arch))
    batch = _torch_batch(batch_for(rc, seed=2))
    outs = [trainstep.value_and_grad(params, batch, pc, trainstep.TrainStepConfig(remat=r))
            for r in (False, True)]
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(convert.params_to_numpy(outs[0][2], pc).values(),
                    convert.params_to_numpy(outs[1][2], pc).values()):
        for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
            np.testing.assert_array_equal(x, y)
