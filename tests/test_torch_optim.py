"""The port's quantizers for training and its AdamW against the JAX reference.

``quantize_chunked`` / ``dequantize_chunked`` bit for bit; ``fake_quant``'s
forward bit for bit and its straight-through gradient; ``quantize_stochastic``
by the reference's own properties (its noise comes from a
``torch.Generator``, so its codes cannot be the reference's).  ``adamw``
against the reference over 3 updates on qwen3-1.7b's smoke parameters
(2 layers; every norm leaf, stacked over the layers, is shorter than the
256-element chunk, so a chunk of an int8 moment spans layers) for each
moment dtype: parameters and f32 moments within float32 rounding, bf16
moments within one bf16 ulp an update (and the parameters within what
such flips move), int8 payloads code for code except at a rounding boundary; ``cosine_schedule``,
``global_norm`` and clipping; the reference's ``TestAdamW`` as twins.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.core import quant as ref_quant
from repro.models import model as ref_model
from repro.optim import adamw as ref_adamw
from repro.sharding import partitioning as P
from repro_torch import convert
from repro_torch import tree as tree_lib
from repro_torch.configs import get_smoke_config
from repro_torch.core import quant
from repro_torch.optim import adamw

jax.config.update("jax_platform_name", "cpu")

#: float32 rounding of the update arithmetic (pow, cos and the sums of the
#: global norm in another order): relative to the largest element of a leaf
F32_RTOL = 1e-5
#: an int8 moment code may differ where the float moment lies within this
#: share of a step of its rounding boundary
FLIP_TOL = 1e-3
#: bf16 moments: where the float32 moment lies at a bf16 rounding boundary the
#: two round one ulp apart (2^-7 of the value at most, relative), once an
#: update, and the flip carries into the next: moments within 3 ulps after 3
#: updates; it moves that element's update by as much, so the parameters
#: within peak_lr · 2^-6 (an update's magnitude is at most ~3 after bias
#: correction)
BF16_MOMENT_RTOL = 3 * 2.0 ** -7


def _t(a):
    return torch.from_numpy(np.array(a))


class TestQuantizers:
    @pytest.mark.parametrize("shape", [(7,), (256,), (3, 300), (2, 5, 129)])
    def test_chunked_bit_identical(self, shape):
        x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
        x.reshape(-1)[:3] = [0.0, 1e-12, -5.0]
        q, s, n = quant.quantize_chunked(_t(x))
        rq, rs, rn = ref_quant.quantize_chunked(jnp.asarray(x))
        assert n == rn
        np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
        back = quant.dequantize_chunked(q, s, n, shape)
        want = ref_quant.dequantize_chunked(rq, rs, rn, shape)
        np.testing.assert_array_equal(back.numpy(), np.asarray(want))
        assert np.abs(back.numpy() - x).max() <= s.max().item() / 2 + 1e-7

    @pytest.mark.parametrize("bits,axis", [(8, -1), (8, 0), (4, -1)])
    def test_fake_quant_forward_bit_identical_gradient_identity(self, bits, axis):
        x = np.random.default_rng(1).normal(size=(6, 40)).astype(np.float32)
        xt = _t(x).requires_grad_(True)
        y = quant.fake_quant(xt, bits, axis)
        want, vjp = jax.vjp(lambda a: ref_quant.fake_quant(a, bits, axis), jnp.asarray(x))
        np.testing.assert_array_equal(y.detach().numpy(), np.asarray(want))
        g = np.random.default_rng(2).normal(size=x.shape).astype(np.float32)
        y.backward(_t(g))
        np.testing.assert_array_equal(xt.grad.numpy(), g)
        np.testing.assert_array_equal(np.asarray(vjp(jnp.asarray(g))[0]), g)

    def test_stochastic_unbiased_and_in_range(self):
        """The reference's properties: the scale is round-to-nearest's, the
        codes in range and within one step of x / s, unbiased in mean."""
        x = np.random.default_rng(3).normal(size=(4, 512)).astype(np.float32)
        gen = torch.Generator().manual_seed(0)
        qts = [quant.quantize_stochastic(_t(x), gen) for _ in range(200)]
        np.testing.assert_array_equal(qts[0].scale.numpy(),
                                      np.asarray(ref_quant.quantize(jnp.asarray(x)).scale))
        s = qts[0].scale.numpy()
        codes = np.stack([q.data.numpy() for q in qts]).astype(np.float64)
        assert codes.min() >= -128 and codes.max() <= 127
        assert np.abs(codes - x / s).max() <= 1.0 + 1e-6
        # the mean of 200 draws has std <= 0.5 / sqrt(200) ~ 0.035 a code
        bias = (codes.mean(0) - x / s)
        assert abs(bias.mean()) < 0.01 and np.abs(bias).max() < 0.25
        again = quant.quantize_stochastic(_t(x), torch.Generator().manual_seed(0))
        assert torch.equal(again.data, qts[0].data)  # the generator decides


ARCH = "qwen3-1.7b"


def _smoke():
    rc = ref_smoke_config(ARCH).scaled(dtype=jnp.float32)
    pc = get_smoke_config(ARCH).scaled(dtype=torch.float32)
    return rc, pc


def _params_and_grads(seed=0):
    """The reference's smoke parameters (norms drawn around 1) and three
    seeded gradient trees of their shapes, some leaves scaled up or down."""
    rc, _ = _smoke()
    params = P.materialize(ref_model.specs(rc, 1), jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, 0.3, a.shape).astype(np.float32)
        if a.ndim <= 2 and a.shape[-1] <= 64 else np.asarray(a), params)
    grads = [jax.tree_util.tree_map(
        lambda a: (rng.normal(size=a.shape) * 10.0 ** rng.integers(-4, 0)).astype(np.float32),
        params) for _ in range(3)]
    return params, grads


def _stacked_moments(state, layout):
    """The port's moments as the reference's numpy leaves."""
    def one(m):
        payload = m.payload
        if isinstance(payload, convert.Stacked):
            payload = torch.stack(list(payload))
        return {"payload": payload.float().numpy(), "scale": m.scale.numpy()}

    return [one(m) for m in tree_lib.leaves(state.mu)], [one(m) for m in
                                                          tree_lib.leaves(state.nu)]


def _max_rel(a, b):
    return np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max() / max(
        np.abs(np.asarray(b, np.float64)).max(), 1e-30)


@pytest.mark.parametrize("moment_dtype", ["f32", "bf16", "int8"])
def test_adamw_matches_reference_over_three_updates(moment_dtype):
    rc, pc = _smoke()
    params, grads = _params_and_grads()
    sched_kw = dict(peak_lr=1e-2, warmup=2, total=10)
    ref_opt = ref_adamw.adamw(ref_adamw.cosine_schedule(**sched_kw), moment_dtype=moment_dtype,
                              clip_norm=1.0)
    opt = adamw.adamw(adamw.cosine_schedule(**sched_kw), moment_dtype=moment_dtype,
                      clip_norm=1.0)
    rp = jax.tree_util.tree_map(jnp.asarray, params)
    rs = ref_opt.init(rp)
    pp = convert.params_from_numpy(params, pc, "cpu")
    layout = convert.reference_layout(pp, pc)
    ps = opt.init(layout)
    for g in grads:
        rupd, rs = ref_opt.update(jax.tree_util.tree_map(jnp.asarray, g), rs, rp)
        rp = ref_adamw.apply_updates(rp, rupd)
        pg = convert.reference_layout(convert.params_from_numpy(g, pc, "cpu"), pc)
        upd, ps = opt.update(pg, ps, layout)
        adamw.apply_updates(layout, upd)
    assert int(ps.step) == int(rs.step) == 3
    got = convert.params_to_numpy(pp, pc)
    for (path, want), have in zip(jax.tree_util.tree_leaves_with_path(rp),
                                  jax.tree_util.tree_leaves(got)):
        if moment_dtype == "bf16":
            np.testing.assert_allclose(have, want, rtol=0,
                                       atol=sched_kw["peak_lr"] * 2.0 ** -6)
        else:
            assert _max_rel(have, want) <= F32_RTOL, jax.tree_util.keystr(path)
    is_m = lambda x: isinstance(x, ref_adamw.Moment)
    ref_mu = jax.tree_util.tree_leaves(rs.mu, is_leaf=is_m)
    ref_nu = jax.tree_util.tree_leaves(rs.nu, is_leaf=is_m)
    mu, nu = _stacked_moments(ps, layout)
    assert len(mu) == len(ref_mu)
    flips = 0
    for mine, ref in zip(mu + nu, ref_mu + ref_nu):
        want = np.asarray(ref.payload).astype(np.float32)
        if moment_dtype == "f32":
            assert _max_rel(mine["payload"], want) <= F32_RTOL
            continue
        if moment_dtype == "bf16":
            np.testing.assert_allclose(mine["payload"], want, rtol=BF16_MOMENT_RTOL, atol=1e-30)
            continue
        # int8: scales within float rounding, codes equal but where the float
        # moment sat on a rounding boundary (x / s within FLIP_TOL of k + 0.5)
        np.testing.assert_allclose(mine["scale"], np.asarray(ref.scale), rtol=F32_RTOL)
        assert mine["payload"].shape == want.shape
        diff = mine["payload"] != want
        if diff.any():
            assert np.abs(mine["payload"] - want)[diff].max() == 1
            frac = (mine["payload"] + want)[diff] / 2  # the boundary both sides share
            assert (np.abs(frac - np.round(frac)) == 0.5).all()
            flips += int(diff.sum())
    total = sum(m["payload"].size for m in mu + nu)
    assert flips <= FLIP_TOL * total


def test_int8_moment_chunks_span_the_stacked_layers():
    """A norm scale of 64 elements a layer, stacked over 2 layers, is one
    256-element chunk: one scale over both layers, as in the reference."""
    _, pc = _smoke()
    params, _ = _params_and_grads()
    pp = convert.params_from_numpy(params, pc, "cpu")
    layout = convert.reference_layout(pp, pc)
    state = adamw.adamw(1e-3, moment_dtype="int8").init(layout)
    m = state.mu["stack"]["slot0"]["ln1"]["scale"]
    assert layout["stack"]["slot0"]["ln1"]["scale"].shape == (2, 64)
    assert m.payload.shape == (1, 256) and m.scale.shape == (1, 1)
    ref_state = ref_adamw.adamw(1e-3, moment_dtype="int8").init(params)
    ref_m = ref_state.mu["stack"]["slot0"]["ln1"]["scale"]
    assert tuple(ref_m.payload.shape) == (1, 256)


@pytest.mark.parametrize("moment_dtype", ["f32", "bf16", "int8"])
def test_init_abstract_has_the_reference_shapes(moment_dtype):
    _, pc = _smoke()
    params, _ = _params_and_grads()
    layout = convert.reference_layout(convert.params_from_numpy(params, pc, "cpu"), pc)
    abst = adamw.adamw(1e-3, moment_dtype=moment_dtype).init_abstract(layout)
    ref = ref_adamw.adamw(1e-3, moment_dtype=moment_dtype).init_abstract(
        jax.tree_util.tree_map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), params))
    mine = [abst.step] + [t for m in tree_lib.leaves(abst.mu) for t in m]
    theirs = [ref.step] + jax.tree_util.tree_leaves(ref.mu)
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        assert a.device.type == "meta"
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype).removeprefix("torch.") == {
            "float32": "float32", "bfloat16": "bfloat16", "int8": "int8",
            "int32": "int32"}[str(b.dtype)]


def test_cosine_schedule_matches_reference():
    for kw in (dict(peak_lr=3e-4, warmup=20, total=100), dict(peak_lr=1.0, warmup=0, total=7),
               dict(peak_lr=5e-3, warmup=5, total=30, floor=0.0)):
        fn, ref = adamw.cosine_schedule(**kw), ref_adamw.cosine_schedule(**kw)
        for step in (0, 1, 3, kw["warmup"], kw["warmup"] + 1, kw["total"] - 1, kw["total"],
                     kw["total"] + 9):
            got = fn(torch.tensor(step, dtype=torch.int32)).item()
            want = float(ref(jnp.asarray(step, jnp.int32)))
            assert got == pytest.approx(want, rel=1e-6, abs=1e-12), (kw, step)


def test_global_norm_and_clipping_match_reference():
    _, pc = _smoke()
    params, grads = _params_and_grads()
    g = grads[0]
    layout = convert.reference_layout(convert.params_from_numpy(g, pc, "cpu"), pc)
    assert adamw.global_norm(layout).item() == pytest.approx(
        float(ref_adamw.global_norm(jax.tree_util.tree_map(jnp.asarray, g))), rel=1e-6)
    # a gradient far above the clip: the update is bounded as the reference's
    big = {"w": torch.full((8,), 1e6)}
    opt = adamw.adamw(1.0, wd=0.0, clip_norm=1.0)
    upd, _ = opt.update(big, opt.init({"w": torch.zeros(8)}), {"w": torch.zeros(8)})
    ref_opt = ref_adamw.adamw(1.0, wd=0.0, clip_norm=1.0)
    rupd, _ = ref_opt.update({"w": jnp.full(8, 1e6)}, ref_opt.init({"w": jnp.zeros(8)}),
                             {"w": jnp.zeros(8)})
    np.testing.assert_allclose(upd["w"].numpy(), np.asarray(rupd["w"]), rtol=1e-6)
    assert upd["w"].abs().max().item() < 1.1


def _quad_problem():
    """The reference's min ||p - t||²: AdamW must converge near t."""
    target = {"a": torch.tensor([1.0, -2.0, 3.0]), "b": {"c": torch.full((4, 4), 0.5)}}
    params = tree_lib.map_leaves(torch.zeros_like, target)
    return params, target


@pytest.mark.parametrize("moment_dtype", ["f32", "bf16", "int8"])
def test_converges(moment_dtype):
    params, target = _quad_problem()
    opt = adamw.adamw(0.05, wd=0.0, moment_dtype=moment_dtype)
    state = opt.init(params)
    for _ in range(300):
        g = tree_lib.map_leaves(lambda p, t: 2 * (p - t), params, target)
        upd, state = opt.update(g, state, params)
        adamw.apply_updates(params, upd)
    loss = sum(torch.sum(torch.square(p - t)).item()
               for p, t in zip(tree_lib.leaves(params), tree_lib.leaves(target)))
    assert loss < 1e-2, moment_dtype


def test_int8_moments_memory():
    """int8 moments store 1 byte + a scale per 256 elements."""
    state = adamw.adamw(1e-3, moment_dtype="int8").init({"w": torch.zeros((1024, 256))})
    m = state.mu["w"]
    assert m.payload.dtype == torch.int8
    assert m.payload.numel() + m.scale.numel() * 4 < 1024 * 256 * 4 / 3.5


def test_params_to_numpy_inverts_params_from_numpy():
    rng = np.random.default_rng(4)
    for arch in ("qwen3-1.7b", "deepseek-v2-lite-16b", "jamba-1.5-large-398b",
                 "seamless-m4t-medium"):
        rc = ref_smoke_config(arch)  # bf16 leaves: ml_dtypes arrays cross bit for bit
        # the reference's tree of specs, filled from numpy (every bit pattern matters,
        # not the init rule)
        params = jax.tree_util.tree_map(
            lambda sp: rng.normal(size=sp.shape).astype(np.dtype(sp.dtype)),
            ref_model.specs(rc, 1), is_leaf=P.is_spec)
        port = convert.params_from_numpy(params, get_smoke_config(arch), "cpu")
        back = convert.params_to_numpy(port, get_smoke_config(arch))
        assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
        for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
