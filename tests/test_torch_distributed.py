"""Training over a device mesh: the port's four ranks against the reference.

One spawn of four gloo ranks on ``localhost`` (``tests/_torch_train_rank.py``,
which imports only ``repro_torch``) runs every mesh case at qwen3-1.7b's
smoke size in float32 while this process computes the reference's side;
then the ranks' files are held here against it.  The reference runs on
Auto-typed meshes of the eight forced host devices (``tests/conftest.py``;
jax 0.9's default Explicit axes make its sharded gathers raise), its
parameters placed by ``P.shardings``, its batch by ``shard_batch``.

Held:

* ``(data=2, model=2)``, FSDP + TP, the first batch's labels masked on one
  data rank only: the first step's loss and metrics within 1e-5 and its
  global gradients within 1e-5 of each leaf's largest |value| of the
  reference's; with f32 moments the parameters after two steps within
  1e-5 of each leaf's largest |value| but for the elements Adam's first
  steps move by sign(g) (a gradient within rounding of zero: up to 2 · lr a
  step), which are counted and printed; with int8 moments, update by
  update (the reference's second step from the port's first state), the
  scales within 1e-5 and the codes equal but at a rounding boundary;
* every leaf no axis shards bitwise equal on the four ranks;
* ``(pod=2, data=2)`` with ``compress_pod_grads``: the hop's output is the
  dequantized quantization of the global gradient, code for code, and the
  step's parameters are the reference's sharded step's; the standalone
  ``compressed_psum`` averages distinct per-pod values within the
  reference's bound and equals the reference's on equal values;
* ``(pipe=2, data=2)``: ``pipeline_apply`` equal to the reference's on a
  tanh stage, and over the 2-layer cut's layers equal to the sequential
  stack;
* the trainer's restart on four ranks in the reference trainer's step
  pattern, its checkpoint restored at one device in both packages and
  trained one more step alike.

In process: ``compression_ratio``, ``split_stages``, ``plan_elastic_mesh``
over a table of device counts and ``shard_batch``'s rows (the launcher's
mesh is in ``tests/test_torch_train.py``).
"""

import json
import os
import shutil
import socket
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType, NamedSharding
from jax.sharding import PartitionSpec as PS

import _torch_train_rank as R
from repro.checkpoint import ckpt as ref_ckpt
from repro.configs import get_smoke_config as ref_smoke_config
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.data.pipeline import shard_batch as ref_shard_batch
from repro.distributed import collectives as ref_collectives
from repro.distributed import pipeline as ref_pipeline
from repro.distributed import resilience as ref_resilience
from repro.models import model as ref_model
from repro.optim import adamw as ref_adamw
from repro.sharding import partitioning as RP
from repro.train import trainer as ref_trainer
from repro.train.trainstep import TrainStepConfig as RefStepConfig
from repro.train.trainstep import make_train_step as ref_make_train_step
from repro_torch.configs import get_smoke_config
from repro_torch.core import quant
from repro_torch.data.pipeline import DataConfig, shard_batch
from repro_torch.distributed import collectives, pipeline, resilience
from repro_torch.distributed.mesh import Axis, MeshView
from repro_torch.sharding import partitioning as P
from repro_torch.train import trainer as trainer_lib

jax.config.update("jax_platform_name", "cpu")

HERE = Path(__file__).resolve().parent
#: seconds the spawned ranks may take, start to exit
JOIN_S = 240
#: the loss, the metrics and each gradient leaf (relative to its largest
#: |value|): float32 sums over ranks in another order
RTOL = 1e-5
#: an int8 code may differ where its float moment lies within this share of
#: a step of the boundary between two codes, on at most this share of codes
FLIP_TOL = 1e-3


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rc():
    return R.smoke_cfg((ref_smoke_config, jnp.float32))


def _mesh(shape, names):
    n = int(np.prod(shape))
    return jax.make_mesh(shape, names, axis_types=(AxisType.Auto,) * len(shape),
                         devices=jax.devices()[:n])


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _batches(cfg):
    src = RefSyntheticLM(RefDataConfig(vocab_size=cfg.vocab_size, **R.DATA))
    return [{k: jnp.asarray(v) for k, v in b.items()} for b in R.batches(src)]


def _ref_steps(params, shape, names, tp, moment, *, compress=False, microbatches=1,
               steps=R.STEPS):
    """The reference's sharded train step on an Auto-typed mesh: from
    ``params`` over ``steps`` batches → [(params, opt state, metrics) a
    step]."""
    cfg = _rc()
    mesh = _mesh(shape, names)
    rules = RP.base_rules(fsdp=True, data_axes=tuple(a for a in ("pod", "data") if a in names))
    opt = ref_adamw.adamw(R.LR, moment_dtype=moment)
    step_cfg = RefStepConfig(compress_pod_grads=compress, microbatches=microbatches)
    step = jax.jit(ref_make_train_step(cfg, opt, tp=tp, rules=rules, mesh=mesh,
                                       step_cfg=step_cfg))
    out = []
    with jax.set_mesh(mesh):
        sh = RP.shardings(ref_model.specs(cfg, tp), mesh, rules)
        p = jax.device_put(params, sh)
        s = opt.init(p)
        for b in _batches(cfg)[:steps]:
            p, s, m = step(p, s, ref_shard_batch(b, mesh, rules))
            out.append(jax.tree_util.tree_map(np.asarray, (p, s, m)))
    return out


def _ref_grads(params):
    """The reference's first-step loss, metrics and gradients (one device:
    GSPMD's sharded value equals it by construction)."""
    cfg = _rc()
    b = _batches(cfg)[0]
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: ref_model.loss_fn(p, b, cfg, remat=True), has_aux=True))(params)
    return float(loss), {k: float(v) for k, v in metrics.items()}, _flat(grads)


def _pipe_inputs():
    rng = np.random.default_rng(2)
    ws = (rng.normal(size=(2, R.PIPE_W, R.PIPE_W)) / 4).astype(np.float32)
    xs = rng.normal(size=(R.PIPE_M, R.PIPE_MB, R.PIPE_W)).astype(np.float32)
    return ws, xs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Spawn the four ranks, compute the reference meanwhile, join them
    within :data:`JOIN_S` → (reference results, [each rank's files])."""
    work = tmp_path_factory.mktemp("mesh")
    params = RP.materialize(ref_model.specs(_rc(), 1), jax.random.PRNGKey(0))
    np.savez(work / "params.npz", **_flat(params))
    ws, xs = _pipe_inputs()
    np.savez(work / "pipe_stage.npz", ws=ws, xs=xs)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(HERE.parent / "src")] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    port, procs = _free_port(), []
    t0 = time.monotonic()
    for rank in range(R.WORLD):
        arg = json.dumps({"rank": rank, "world": R.WORLD, "port": port, "workdir": str(work)})
        log = open(work / f"rank{rank}.log", "w")
        procs.append((subprocess.Popen([sys.executable, str(HERE / "_torch_train_rank.py"), arg],
                                       env=env, stdout=log, stderr=subprocess.STDOUT), log))
    int8 = _Int8Steps()
    ref = {"params": params, "grads": _ref_grads(params), "dm_int8": [int8.run(params, None, 0)],
           "dm_f32": _ref_steps(params, (2, 2), ("data", "model"), 2, "f32"),
           "dm_mb2": _ref_steps(params, (2, 2), ("data", "model"), 2, "f32", microbatches=2,
                                steps=1),
           "pod": _ref_steps(params, (2, 2, 1), ("pod", "data", "model"), 1, "f32",
                             compress=True, steps=1)}
    pods = _mesh((2, 2, 2), ("pod", "data", "model"))
    with jax.set_mesh(pods):
        g = np.random.default_rng(1).normal(size=(64, 32)).astype(np.float32)
        ref["psum_same"] = np.asarray(ref_collectives.compressed_psum_tree(
            {"g": jnp.asarray(g)}, pods, "pod")["g"])
    ref["pipe"] = np.asarray(ref_pipeline.pipeline_apply(
        lambda w, h: jnp.tanh(h @ w), jnp.asarray(ws), jnp.asarray(xs),
        _mesh((2, 2), ("pipe", "data")), axis="pipe"))
    for proc, log in procs:
        try:
            proc.wait(timeout=max(1.0, JOIN_S - (time.monotonic() - t0)))
        except subprocess.TimeoutExpired:
            for p, _ in procs:
                p.kill()
        log.close()
    logs = [(work / f"rank{r}.log").read_text()[-3000:] for r in range(R.WORLD)]
    assert all(p.returncode == 0 for p, _ in procs), "\n".join(logs)
    ranks = []
    for r in range(R.WORLD):
        files = {}
        for case in ("dm_f32", "dm_int8", "dm_mb2", "pod", "psum", "pipe", "trainer"):
            with np.load(work / f"{case}_rank{r}.npz") as z:
                files[case] = {k: z[k] for k in z.files}
        ranks.append(files)
    # the int8 case, update by update: each later reference step from the port's state
    for i in range(1, R.STEPS):
        ref["dm_int8"].append(int8.run(*_state_tree(ranks[0]["dm_int8"], f"step{i - 1}"), i))
    return ref, ranks, work


def _state_tree(files, prefix):
    """A rank's saved global state (the checkpoint tree) → (reference params,
    reference ``AdamState``)."""
    tree = R._nest({k[len(prefix) + 7:]: v for k, v in files.items()
                    if k.startswith(f"{prefix}/state/")})
    return (jax.tree_util.tree_map(jnp.asarray, tree["params"]),
            ref_trainer._retuple(jax.tree_util.tree_map(jnp.asarray, tree["opt_state"])))


class _Int8Steps:
    """The reference's sharded int8 step at ``(data=2, model=2)``, jitted once:
    ``run(params, state, i)`` takes step ``i`` from the given state (None:
    the optimizer's zero state)."""

    def __init__(self):
        cfg = _rc()
        self.opt = ref_adamw.adamw(R.LR, moment_dtype="int8")
        self.mesh = _mesh((2, 2), ("data", "model"))
        self.rules = RP.base_rules(fsdp=True, data_axes=("data",))
        self.step = jax.jit(ref_make_train_step(cfg, self.opt, tp=2, rules=self.rules,
                                                mesh=self.mesh))
        self.batches = _batches(cfg)
        self.sh = RP.shardings(ref_model.specs(cfg, 2), self.mesh, self.rules)

    def run(self, params, state, i):
        with jax.set_mesh(self.mesh):
            p = jax.device_put(params, self.sh)
            s = self.opt.init(p) if state is None else jax.device_put(
                state, NamedSharding(self.mesh, PS()))
            out = self.step(p, s, ref_shard_batch(self.batches[i], self.mesh, self.rules))
        return jax.tree_util.tree_map(np.asarray, out)


def _leaf_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _hold_params(got: dict, want, steps: int, label: str, bounded: bool = True) -> int:
    """Every leaf within :data:`RTOL` of its largest |value| but for the
    elements Adam's sign(g) moves (at most 2 · lr a step off), counted and
    at most :data:`FLIP_TOL` of them.  ``bounded=False`` (an int8 update
    after the first): an element whose second moment dequantizes to 0
    divides its update by eps alone, so the gradient's float32 rounding can
    move it by more than 2 · lr; such elements are counted alike, with no
    bound of their own."""
    signs, worst = 0, 0.0
    for key, w in _flat(want).items():
        g = np.asarray(got[key], np.float64)
        w = np.asarray(w, np.float64)
        d = np.abs(g - w)
        loose = d > RTOL * np.abs(w).max()
        if bounded:
            assert (d[loose] <= 2 * R.LR * steps * (1 + 1e-3)).all(), (label, key, d.max())
        signs += int(loose.sum())
        worst = max(worst, float(d.max(initial=0.0)) / R.LR)
    n = sum(np.asarray(v).size for v in _flat(want).values())
    print(f"{label}: {signs} of {n} parameter elements off by more than {RTOL} of their "
          f"leaf's largest, the farthest {worst:.3f} lr")
    assert signs <= FLIP_TOL * n, signs
    return signs


def test_first_step_loss_and_gradients_match_reference(runs):
    ref, ranks, _ = runs
    loss, metrics, grads = ref["grads"]
    for r in ranks:
        got = r["dm_f32"]
        assert abs(float(got["step0/loss"]) - loss) <= RTOL * abs(loss)
        for k in ("ce", "z", "tokens"):
            assert abs(float(got[f"step0/{k}"]) - metrics[k]) <= RTOL * abs(metrics[k]), k
    assert float(ranks[0]["dm_f32"]["step0/tokens"]) == R.DATA["seq_len"] * 4 - R.MASKED
    for key, want in grads.items():
        assert _leaf_err(ranks[0]["dm_f32"][f"grads/{key}"], want) <= RTOL, key


def test_fsdp_tp_two_steps_f32_match_reference(runs):
    ref, ranks, _ = runs
    for i, (p, _, m) in enumerate(ref["dm_f32"]):
        got = ranks[0]["dm_f32"]
        for k in ("loss", "ce", "z", "grad_norm"):
            assert abs(float(got[f"step{i}/{k}"]) - float(m[k])) <= RTOL * abs(float(m[k])), k
        params = {k[len(f"step{i}/state/params/"):]: v for k, v in got.items()
                  if k.startswith(f"step{i}/state/params/")}
        _hold_params(params, p, i + 1, f"(data=2, model=2) f32 step {i}")


def test_fsdp_tp_two_microbatches_match_reference(runs):
    """Two microbatches with the first batch's row 0 masked: each rank's
    slice is divided by the token count of the reference's microbatch it
    falls in, so the step is the reference's."""
    ref, ranks, _ = runs
    p, _, m = ref["dm_mb2"][0]
    got = ranks[0]["dm_mb2"]
    for k in ("loss", "ce", "z", "tokens", "grad_norm"):
        assert abs(float(got[f"step0/{k}"]) - float(m[k])) <= RTOL * abs(float(m[k])), k
    params = {k[len("step0/state/params/"):]: v for k, v in got.items()
              if k.startswith("step0/state/params/")}
    _hold_params(params, p, 1, "(data=2, model=2) two microbatches")


def test_fsdp_tp_int8_moments_update_by_update(runs):
    """Each reference step from the port's previous state: the codes equal
    but where the float moment lies at a rounding boundary (the step's
    gradients differ by float32 rounding), the scales within 1e-5."""
    ref, ranks, _ = runs
    for i, (p, s, m) in enumerate(ref["dm_int8"]):
        got = ranks[0]["dm_int8"]
        flips = total = 0
        for name, mom in (("mu", s.mu), ("nu", s.nu)):
            want = _flat(jax.tree_util.tree_map(
                lambda x: {"payload": x.payload, "scale": x.scale}, mom,
                is_leaf=lambda x: isinstance(x, ref_adamw.Moment)))
            for key, w in want.items():
                have = got[f"step{i}/state/opt_state/{name}/{key}"]
                if key.endswith("scale"):
                    assert _leaf_err(have, w) <= RTOL, key
                    continue
                diff = have != w
                assert np.abs(have.astype(np.int32) - w)[diff].max(initial=0) <= 1, key
                flips, total = flips + int(diff.sum()), total + w.size
        print(f"(data=2, model=2) int8 step {i}: {flips} of {total} codes differ by one")
        assert flips <= FLIP_TOL * total
        params = {k[len(f"step{i}/state/params/"):]: v for k, v in got.items()
                  if k.startswith(f"step{i}/state/params/")}
        _hold_params(params, p, 1, f"(data=2, model=2) int8 step {i}", bounded=i == 0)


def test_replicated_leaves_bitwise_equal_on_every_rank(runs):
    _, ranks, _ = runs
    for case in ("dm_f32", "dm_int8", "pod"):
        keys = [k for k in ranks[0][case] if k.startswith("replicated/")]
        assert keys, case
        for r in ranks[1:]:
            for k in keys:
                assert np.array_equal(r[case][k], ranks[0][case][k]), (case, k)


def test_compressed_pod_hop_is_the_quantized_global_gradient(runs):
    """Code for code: the hop's output is ``dequantize_chunked(quantize_chunked(g))``
    of each global stacked leaf; the step matches the reference's sharded
    step with ``compress_pod_grads``."""
    ref, ranks, _ = runs
    got = ranks[0]["pod"]
    for key in [k for k in got if k.startswith("grads/")]:
        g = torch.from_numpy(got[key])  # the port's chunked quantizer is the reference's, bit
        q, s, n = quant.quantize_chunked(g)  # for bit (tests/test_torch_optim.py)
        want = quant.dequantize_chunked(q, s, n, g.shape).numpy()
        assert np.array_equal(got["compressed/" + key[len("grads/"):]], want), key
    p, _, m = ref["pod"][0]
    for k in ("loss", "grad_norm"):
        assert abs(float(got[f"step0/{k}"]) - float(m[k])) <= RTOL * abs(float(m[k])), k
    params = {k[len("step0/state/params/"):]: v for k, v in got.items()
              if k.startswith("step0/state/params/")}
    _hold_params(params, p, 1, "(pod=2, data=2) compressed step 0")
    assert json.loads(str(got["step0/calls"])).get("gather", 0) > 0


def test_compressed_psum_distinct_values_average(runs):
    """The reference's bound: 1.0 on pod 0 and 3.0 on pod 1 average to 2.0
    within 2 / 127; equal values come back within max|x| / 127, equal to
    the reference's."""
    ref, ranks, _ = runs
    for r in ranks:
        np.testing.assert_allclose(r["psum"]["distinct"], 2.0, atol=2.0 / 127 + 1e-6)
        np.testing.assert_array_equal(r["psum"]["exact"], 2.0)
        np.testing.assert_array_equal(r["psum"]["same"], ref["psum_same"])
    g = np.random.default_rng(1).normal(size=(64, 32)).astype(np.float32)
    assert np.abs(ranks[0]["psum"]["same"] - g).max() <= np.abs(g).max() / 127 + 1e-6


def test_pipeline_matches_reference_and_sequential(runs):
    ref, ranks, _ = runs
    for r in ranks:
        np.testing.assert_allclose(r["pipe"]["tanh"], ref["pipe"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r["pipe"]["layers"], r["pipe"]["sequential"],
                                   rtol=1e-5, atol=1e-5)
        assert json.loads(str(r["pipe"]["calls"]))["gather"] > 0


def test_trainer_restart_on_four_ranks_and_checkpoint_at_one_device(runs, tmp_path):
    """The four ranks' trainer failed before step 3 and resumed from step 2,
    as the reference's trainer does; its last checkpoint (the global tree,
    written by rank 0) restores at one device in both packages, and one
    more step of each agrees."""
    _, ranks, work = runs
    want = [0, 1, 2, 2, 3]
    for r in ranks:
        assert list(r["trainer"]["steps"]) == want
        assert np.array_equal(r["trainer"]["losses"], ranks[0]["trainer"]["losses"])
    steps = R.TRAINER["steps"]
    kw = dict(steps=steps + 1, ckpt_every=100, log_every=1, peak_lr=R.LR, warmup=1)
    cfg = get_smoke_config(R.ARCH).scaled(dtype=torch.float32)
    shutil.copytree(work / "ckpt", tmp_path / "port")
    # the reference's reader needs its own manifest (a JAX treedef): the same
    # leaves written back by the reference's writer, file for file equal
    tree, extra = trainer_lib.ckpt_lib.restore(str(work / "ckpt"))
    assert extra == {"step": steps}
    ref_ckpt.save(jax.tree_util.tree_map(lambda t: jnp.asarray(_np(t)), tree),
                  str(tmp_path / "ref"), steps, extra=extra)
    for name in os.listdir(work / "ckpt" / f"step_{steps:09d}"):
        if name.endswith(".npy"):
            assert (work / "ckpt" / f"step_{steps:09d}" / name).read_bytes() == (
                tmp_path / "ref" / f"step_{steps:09d}" / name).read_bytes(), name
    port = trainer_lib.Trainer(cfg, DataConfig(vocab_size=cfg.vocab_size, **R.DATA),
                               trainer_lib.TrainerConfig(ckpt_dir=str(tmp_path / "port"), **kw),
                               device="cpu").run()
    ref = ref_trainer.Trainer(_rc(), RefDataConfig(vocab_size=cfg.vocab_size, **R.DATA),
                              ref_trainer.TrainerConfig(ckpt_dir=str(tmp_path / "ref"),
                                                        **kw)).run()
    assert [h["step"] for h in port["history"]] == [h["step"] for h in ref["history"]] == [steps]
    assert abs(port["history"][0]["loss"] - ref["history"][0]["loss"]) <= RTOL * abs(
        ref["history"][0]["loss"])
    got = trainer_lib.convert.params_to_numpy(port["params"], cfg)
    _hold_params(_flat(got), ref["params"], 1, "checkpoint of four ranks, one more step")


def _np(t):
    """A restored CPU tensor as numpy (bfloat16 through ml_dtypes)."""
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


# ---------------------------------------------------------------------------
# In process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1024, 1024), (7,), (256,), (3, 300)])
def test_compression_ratio(shape):
    assert collectives.compression_ratio(shape) == ref_collectives.compression_ratio(shape)


def test_split_stages():
    tree = {"w": np.arange(8 * 3 * 3, dtype=np.float32).reshape(8, 3, 3)}
    got = pipeline.split_stages({"w": torch.from_numpy(tree["w"])}, 4)["w"]
    want = ref_pipeline.split_stages({"w": jnp.asarray(tree["w"])}, 4)["w"]
    assert tuple(got.shape) == tuple(want.shape) == (4, 2, 3, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError):
        pipeline.split_stages({"w": torch.zeros(6, 2)}, 4)


@pytest.mark.parametrize("model_parallel", [1, 2, 16])
def test_plan_elastic_mesh_table(model_parallel):
    for n in (0, 1, 2, 3, 7, 8, 15, 16, 17, 240, 512):
        for min_data in (1, 2):
            want = ref_resilience.plan_elastic_mesh(n, model_parallel=model_parallel,
                                                    min_data=min_data)
            assert resilience.plan_elastic_mesh(n, model_parallel=model_parallel,
                                                min_data=min_data) == want


@pytest.mark.parametrize("shape,names", [((2, 2), ("data", "model")),
                                         ((2, 2, 2), ("pod", "data", "model")),
                                         ((4, 2), ("data", "model"))])
def test_shard_batch_rows_match_reference(shape, names):
    """Each device's rows of the reference's placed batch are the rows
    ``shard_batch`` gives the rank at its coordinates."""
    rules = RP.base_rules(data_axes=tuple(a for a in ("pod", "data") if a in names))
    batch = {"tokens": np.arange(8 * 5, dtype=np.int32).reshape(8, 5),
             "labels": np.arange(8 * 5, dtype=np.int32).reshape(8, 5) + 100}
    mesh = _mesh(shape, names)
    placed = ref_shard_batch({k: jnp.asarray(v) for k, v in batch.items()}, mesh, rules)
    coords = {d: dict(zip(names, c)) for c, d in np.ndenumerate(mesh.devices)}
    for key, arr in placed.items():
        assert isinstance(arr.sharding, NamedSharding)
        for shard in arr.addressable_shards:
            view = MeshView({n: Axis(size=s, rank=coords[shard.device][n])
                             for n, s in zip(names, shape)})
            got = shard_batch(batch, view, P.base_rules(data_axes=rules["batch"]))[key]
            np.testing.assert_array_equal(got, np.asarray(shard.data))
