"""The port's training loop against the JAX reference: data, train step,
trainer, checkpoints and the launchers.

``SyntheticLM`` batches bit-identical; the microbatched step against the
single step (the reference's own check, and in float32 the gradients
within rounding); three train steps of qwen3-1.7b's (f32 moments) and
deepseek-v2-lite-16b's (bf16 moments, 2 microbatches) smoke configs
(float32) against three of the reference's from the same parameters and
batches (int8 moments are held update by update in
``tests/test_torch_optim.py``: over whole steps an int8 second moment that
rounds to code 0 in one package and not the other divides that element's
update by eps alone, ~800 · lr apart, in either package); the trainer's loss
falling, and its restart after ``FailureSim(fail_at=(12,))`` giving the
reference trainer's step pattern with final parameters bitwise equal to an
uninterrupted run's; checkpoints (round trip, ``latest_step``, CRC
corruption, the async writer, the leaf files and CRCs of a restored state
equal to the reference's, a reference trainer's checkpoint restored by the
port's trainer and trained on in step with the reference's); the train
launcher and ``launch.serve --ckpt-dir``.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as ref_ckpt
from repro.configs import get_smoke_config as ref_smoke_config
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.distributed.resilience import FailureSim as RefFailureSim
from repro.models import model as ref_model
from repro.optim import adamw as ref_adamw
from repro.sharding import partitioning as P
from repro.train import trainer as ref_trainer
from repro.train.trainstep import TrainStepConfig as RefStepConfig
from repro.train.trainstep import make_train_step as ref_make_train_step
from repro_torch import convert
from repro_torch import tree as tree_lib
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM, prefetch, to_device
from repro_torch.distributed.resilience import FailureSim
from repro_torch.launch import serve as serve_launch
from repro_torch.launch import train as train_launch
from repro_torch.models import model as model_lib
from repro_torch.optim import adamw
from repro_torch.train import trainer as trainer_lib
from repro_torch.train import trainstep

jax.config.update("jax_platform_name", "cpu")

ARCH = "qwen3-1.7b"
#: the steps' losses and grad norms: float32 sums in another order
STEP_RTOL = 1e-5
#: parameters after a few steps, in units of the peak learning rate: AdamW
#: divides by sqrt(v) + eps, so an element whose gradient is near 0 turns a
#: float32 rounding of its gradient (|dg|) into up to |dg| / eps of an
#: update; elements away from 0 agree within PARAM_TIGHT · lr, all but
#: PARAM_SHARE of them (measured: max 0.05 and 0.08 lr, shares 1.2e-5 and
#: 9.8e-5 on qwen3's and deepseek's three steps)
PARAM_MAX, PARAM_TIGHT, PARAM_SHARE = 0.25, 1e-3, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port's tensors here are small: one intra-op thread (the
    process's count restored after the module), so that the test run's
    parallel workers do not oversubscribe the machine's cores; no result
    depends on it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _small(dtype=None):
    """The reference trainer test's config: 2 layers, vocab 128."""
    over = dict(n_layers=2, vocab_size=128)
    rc, pc = ref_smoke_config(ARCH).scaled(**over), get_smoke_config(ARCH).scaled(**over)
    if dtype is not None:
        rc, pc = rc.scaled(dtype=getattr(jnp, dtype)), pc.scaled(dtype=getattr(torch, dtype))
    return rc, pc, dict(vocab_size=128, seq_len=32, global_batch=4, seed=1)


def _leaves_np(tree):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


def _hold_params(want_tree, got_tree, lr):
    """The reference's parameters (a JAX tree) against the port's numpy
    tree, within :data:`PARAM_MAX` · lr everywhere and :data:`PARAM_TIGHT`
    · lr on all but :data:`PARAM_SHARE` of the elements."""
    off = n = 0
    for (path, want), got in zip(jax.tree_util.tree_leaves_with_path(want_tree),
                                 _leaves_np(got_tree)):
        d = np.abs(got.astype(np.float64) - np.asarray(want, np.float64)) / lr
        assert d.max() <= PARAM_MAX, jax.tree_util.keystr(path)
        off, n = off + int((d > PARAM_TIGHT).sum()), n + d.size
    assert off <= PARAM_SHARE * n, off / n


def _port_params(params, pc):
    return convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, params), pc, "cpu")


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(vocab_size=128, seq_len=32, global_batch=4, seed=1),
                                dict(vocab_size=151936, seq_len=64, global_batch=2, seed=0),
                                dict(vocab_size=50, seq_len=3, global_batch=3, seed=7)])
def test_synthetic_batches_bit_identical(kw):
    mine, ref = SyntheticLM(DataConfig(**kw)), RefSyntheticLM(RefDataConfig(**kw))
    for step in (0, 1, 17):
        a, b = mine.batch(step), ref.batch(step)
        assert set(a) == set(b) == {"tokens", "labels"}
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k], b[k])
    it = iter(mine)
    np.testing.assert_array_equal(next(it)["tokens"], ref.batch(0)["tokens"])


def test_prefetch_yields_the_stream_on_the_device():
    src = SyntheticLM(DataConfig(vocab_size=64, seq_len=8, global_batch=2))
    gen = prefetch(iter(src), "cpu", depth=2)
    for step in range(3):
        b = next(gen)
        assert b["tokens"].device.type == "cpu"
        np.testing.assert_array_equal(b["tokens"].numpy(), src.batch(step)["tokens"])
    gen.close()


# ---------------------------------------------------------------------------
# Train step
# ---------------------------------------------------------------------------


def test_microbatched_step_matches_single():
    """The reference's check (bf16 params, its tolerance): grad accumulation
    over 2 microbatches == the full-batch step."""
    _, pc, dkw = _small()
    params = model_lib.draw(pc, 0, "cpu")
    batch = to_device(SyntheticLM(DataConfig(**dkw)).batch(0), "cpu")
    opt = adamw.adamw(1e-3, wd=0.0)
    outs = {}
    for m in (1, 2):
        p = tree_lib.map_leaves(torch.clone, params)
        step = trainstep.make_train_step(
            pc, opt, step_cfg=trainstep.TrainStepConfig(microbatches=m, remat=False))
        p2, _, metrics = step(p, trainstep.init_opt_state(opt, p, pc), batch)
        outs[m] = p2, metrics
    for a, b in zip(tree_lib.leaves(outs[1][0]), tree_lib.leaves(outs[2][0])):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(), rtol=5e-2, atol=5e-3)
    assert outs[1][1]["tokens"].item() == outs[2][1]["tokens"].item() == 4 * 32


def test_microbatched_gradients_float32():
    """In float32 the accumulated gradients and the mean loss are the full
    batch's within rounding."""
    _, pc, dkw = _small("float32")
    params = model_lib.draw(pc, 0, "cpu")
    batch = to_device(SyntheticLM(DataConfig(**dkw)).batch(0), "cpu")
    got = [trainstep.compute_grads(params, batch, pc, trainstep.TrainStepConfig(microbatches=m))
           for m in (1, 2, 4)]
    for loss, metrics, grads in got[1:]:
        assert loss.item() == pytest.approx(got[0][0].item(), rel=STEP_RTOL)
        assert metrics["tokens"].item() == got[0][1]["tokens"].item()
        for a, b in zip(tree_lib.leaves(grads), tree_lib.leaves(got[0][2])):
            assert (a - b).abs().max().item() <= 1e-5 * b.abs().max().item()


def test_step_config_options_that_wait_raise():
    """``probe`` (the reference's cost-counting probe; the port's dry run
    counts by depth itself) and ``compress_pod_grads`` with no mesh (no pod
    to sync over, as the reference's) each leave the step as it is, to the
    bit."""
    _, pc, dkw = _small()
    opt = adamw.adamw(1e-3)
    batch = to_device(SyntheticLM(DataConfig(**dkw)).batch(0), "cpu")
    out = []
    for step_cfg in (trainstep.TrainStepConfig(), trainstep.TrainStepConfig(probe=True),
                     trainstep.TrainStepConfig(compress_pod_grads=True)):
        params = model_lib.materialize(pc, 0, "cpu")
        step = trainstep.make_train_step(pc, opt, step_cfg=step_cfg)
        out.append(step(params, trainstep.init_opt_state(opt, params, pc), batch)[0])
    for other in out[1:]:
        for a, b in zip(tree_lib.leaves(out[0]), tree_lib.leaves(other)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("arch,moment_dtype,m", [("qwen3-1.7b", "f32", 1),
                                                 ("deepseek-v2-lite-16b", "bf16", 2)])
def test_three_train_steps_match_reference(arch, moment_dtype, m):
    rc = ref_smoke_config(arch).scaled(dtype=jnp.float32, vocab_size=128)
    pc = get_smoke_config(arch).scaled(dtype=torch.float32, vocab_size=128)
    data = dict(vocab_size=128, seq_len=32, global_batch=4, seed=3)
    params = P.materialize(ref_model.specs(rc, 1), jax.random.PRNGKey(0))
    sched = dict(peak_lr=3e-3, warmup=1, total=3)
    ref_opt = ref_adamw.adamw(ref_adamw.cosine_schedule(**sched), moment_dtype=moment_dtype)
    opt = adamw.adamw(adamw.cosine_schedule(**sched), moment_dtype=moment_dtype)
    ref_step = jax.jit(ref_make_train_step(rc, ref_opt, step_cfg=RefStepConfig(microbatches=m)))
    step = trainstep.make_train_step(pc, opt, step_cfg=trainstep.TrainStepConfig(microbatches=m))
    rp, rs = params, ref_opt.init(params)
    pp = _port_params(params, pc)
    ps = trainstep.init_opt_state(opt, pp, pc)
    src = SyntheticLM(DataConfig(**data))
    for i in range(3):
        b = src.batch(i)
        rp, rs, rm = ref_step(rp, rs, {k: jnp.asarray(v) for k, v in b.items()})
        pp, ps, pm = step(pp, ps, to_device(b, "cpu"))
        assert set(pm) == set(rm)
        for k in ("loss", "ce", "z", "grad_norm"):
            assert pm[k].item() == pytest.approx(float(rm[k]), rel=STEP_RTOL), (i, k)
        assert pm["aux"].item() == pytest.approx(float(rm["aux"]), rel=STEP_RTOL, abs=1e-7)
        assert pm["tokens"].item() == float(rm["tokens"])
    _hold_params(rp, convert.params_to_numpy(pp, pc), sched["peak_lr"])


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------


def _trainer(tmp, *, steps, ckpt_every, log_every=1, fail_at=(), **kw):
    _, pc, dkw = _small()
    return trainer_lib.Trainer(
        pc, DataConfig(**dkw),
        trainer_lib.TrainerConfig(steps=steps, ckpt_every=ckpt_every, log_every=log_every,
                                  ckpt_dir=tmp, **kw),
        failure_sim=FailureSim(fail_at=fail_at) if fail_at else None, device="cpu")


def test_trainer_loss_decreases(tmp_path):
    tr = _trainer(str(tmp_path), steps=30, ckpt_every=100, log_every=5, peak_lr=5e-3, warmup=5)
    out = tr.run()
    first, last = out["history"][0]["loss"], out["history"][-1]["loss"]
    assert last < first, (first, last)
    assert [h["step"] for h in out["history"]] == [0, 5, 10, 15, 20, 25, 29]
    assert all(h["sec"] > 0 for h in out["history"])


def test_restart_after_failure_matches_reference_and_an_uninterrupted_run(tmp_path):
    """Failure at step 12 → restore from the step-10 checkpoint (int8
    moments) and finish; the step pattern is the reference trainer's, the
    final parameters an uninterrupted run's to the bit."""
    kw = dict(steps=20, ckpt_every=10, peak_lr=1e-3, warmup=2, moment_dtype="int8")
    failed = _trainer(str(tmp_path / "a"), fail_at=(12,), **kw).run()
    clean = _trainer(str(tmp_path / "b"), **kw).run()
    rc, _, dkw = _small()
    ref = ref_trainer.Trainer(
        rc, RefDataConfig(**dkw),
        ref_trainer.TrainerConfig(log_every=1, ckpt_dir=str(tmp_path / "r"), **kw),
        failure_sim=RefFailureSim(fail_at=(12,))).run()
    steps = [h["step"] for h in failed["history"]]
    assert steps == [h["step"] for h in ref["history"]]
    assert 12 in steps and 19 in steps and steps.count(11) == 2 and steps.count(12) == 1
    for a, b in zip(tree_lib.leaves(failed["params"]), tree_lib.leaves(clean["params"])):
        assert torch.equal(a, b)
    assert ckpt.latest_step(str(tmp_path / "a")) == 20


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        tree = {"p": {"w": torch.arange(12.0).reshape(3, 4),
                      "h": torch.randn(5, dtype=torch.float32).to(torch.bfloat16)},
                "s": torch.tensor(7, dtype=torch.int32),
                "q": torch.tensor([-3, 4], dtype=torch.int8)}
        ckpt.save(tree, str(tmp_path), 5, extra={"note": "x"})
        back, extra = ckpt.restore(str(tmp_path))
        assert extra["note"] == "x"
        for path, leaf in tree_lib.flatten(tree):
            got = back
            for k in path:
                got = got[k]
            assert got.dtype == leaf.dtype and torch.equal(got, leaf), path

    def test_latest_step(self, tmp_path):
        for s in (1, 7, 3):
            ckpt.save({"x": torch.zeros(2)}, str(tmp_path), s)
        os.makedirs(tmp_path / "step_000000009.tmp")  # an unpublished write
        assert ckpt.latest_step(str(tmp_path)) == 7
        assert ckpt.latest_step(str(tmp_path / "none")) is None

    def test_crc_detects_corruption(self, tmp_path):
        path = ckpt.save({"x": torch.arange(100.0)}, str(tmp_path), 1)
        leaf = os.path.join(path, "leaf_00000.npy")
        a = np.load(leaf)
        a[0] = 999.0
        np.save(leaf, a)
        with pytest.raises(IOError, match="CRC"):
            ckpt.restore(str(tmp_path), 1)

    def test_async_save(self, tmp_path):
        x = torch.ones((64, 64))
        ac = ckpt.AsyncCheckpointer()
        ac.save({"x": x}, str(tmp_path), 2)
        x.mul_(3.0)  # an in-place update after the snapshot does not reach the file
        ac.wait()
        back, _ = ckpt.restore(str(tmp_path), 2)
        assert torch.equal(back["x"], torch.ones((64, 64)))

    def test_reference_checkpoint_needs_its_key_paths(self, tmp_path):
        ref_ckpt.save({"a": jnp.zeros(3), "b": {"c": jnp.ones(2)}}, str(tmp_path), 1)
        with pytest.raises(ValueError, match="key paths"):
            ckpt.restore(str(tmp_path), 1)
        back, _ = ckpt.restore(str(tmp_path), 1, paths=[("a",), ("b", "c")])
        assert torch.equal(back["b"]["c"], torch.ones(2))


def _reference_run(tmp, rc, dkw, moment_dtype, steps, ckpt_every=10):
    return ref_trainer.Trainer(
        rc, RefDataConfig(**dkw),
        ref_trainer.TrainerConfig(steps=steps, ckpt_every=ckpt_every, log_every=1, ckpt_dir=tmp,
                                  peak_lr=3e-3, warmup=2, moment_dtype=moment_dtype)).run()


@pytest.mark.parametrize("moment_dtype", ["f32", "int8"])
def test_leaf_files_and_crcs_equal_the_reference(tmp_path, moment_dtype):
    """The reference trainer's bf16 checkpoint, restored by the port and
    written again: the same leaf files, shapes, dtypes and CRCs."""
    rc, pc, dkw = _small()
    ref_dir, port_dir = str(tmp_path / "r"), str(tmp_path / "p")
    _reference_run(ref_dir, rc, dkw, moment_dtype, steps=3, ckpt_every=100)
    tree, extra = ckpt.restore(ref_dir, paths=trainer_lib.checkpoint_paths(pc))
    params, state = trainer_lib.state_from_tree(tree, pc, "cpu", moment_dtype)
    ckpt.save(trainer_lib.state_tree(params, state, pc), port_dir, 3, extra=extra)
    with open(os.path.join(ref_dir, "step_000000003", "manifest.json")) as f:
        want = json.load(f)
    with open(os.path.join(port_dir, "step_000000003", "manifest.json")) as f:
        got = json.load(f)
    assert got["leaves"] == want["leaves"]
    assert any(leaf["dtype"] == "bfloat16" for leaf in got["leaves"])
    assert got["extra"] == want["extra"] == {"step": 3}
    assert [tuple(p) for p in got["paths"]] == trainer_lib.checkpoint_paths(pc)


def test_reference_checkpoint_restored_and_trained_in_step(tmp_path):
    """A reference trainer's checkpoint at step 10; the port's trainer and
    the reference's each resume from it to step 15 (float32, f32 moments:
    int8 second moments that round to code 0 divide an update by eps alone,
    which turns rounding into divergence in both packages; the int8 state's
    restore is held to the bit by the CRC test above)."""
    rc, pc, dkw = _small("float32")
    base = str(tmp_path / "base")
    _reference_run(base, rc, dkw, "f32", steps=10)
    shutil.copytree(base, str(tmp_path / "r"))
    ref = _reference_run(str(tmp_path / "r"), rc, dkw, "f32", steps=15)
    tr = trainer_lib.Trainer(
        pc, DataConfig(**dkw),
        trainer_lib.TrainerConfig(steps=15, ckpt_every=10, log_every=1, ckpt_dir=base,
                                  peak_lr=3e-3, warmup=2, moment_dtype="f32"), device="cpu")
    out = tr.run()
    assert [h["step"] for h in out["history"]] == [h["step"] for h in ref["history"]] \
        == list(range(10, 15))
    for mine, theirs in zip(out["history"], ref["history"]):
        assert mine["loss"] == pytest.approx(theirs["loss"], rel=STEP_RTOL), mine["step"]
    _hold_params(ref["params"], convert.params_to_numpy(out["params"], pc), 3e-3)


# ---------------------------------------------------------------------------
# Launchers
# ---------------------------------------------------------------------------


def test_train_launcher_then_serve_its_checkpoint(tmp_path, capsys):
    d = str(tmp_path)
    out = train_launch.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "4",
                             "--seq-len", "16", "--global-batch", "4", "--ckpt-dir", d,
                             "--ckpt-every", "2", "--moment-dtype", "bf16",
                             "--microbatches", "2"])
    assert ckpt.latest_step(d) == 4 and os.path.isdir(os.path.join(d, "step_000000002"))
    assert "done in" in capsys.readouterr().out
    cfg = get_smoke_config(ARCH)
    params = serve_launch.checkpoint_params(d, cfg, "cpu")
    for a, b in zip(tree_lib.leaves(params), tree_lib.leaves(out["params"])):
        assert torch.equal(a, b)
    serve_launch.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--min-dim", "16",
                       "--ckpt-dir", d, "--requests", "2", "--max-new", "3"])
    text = capsys.readouterr().out
    assert f"restore {d}" in text and "served 2 requests / 6 tokens" in text


def test_serve_launcher_reads_a_reference_checkpoint(tmp_path):
    rc, pc, dkw = _small()
    d = str(tmp_path)
    ref = _reference_run(d, rc, dkw, "f32", steps=2, ckpt_every=100)
    params = serve_launch.checkpoint_params(d, pc, "cpu")
    for want, got in zip(_leaves_np(ref["params"]),
                         _leaves_np(convert.params_to_numpy(params, pc))):
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


def test_train_launcher_refuses_parallelism_and_defaults_to_the_card():
    """Over a mesh, NCCL needs a card a rank and is refused by name when the
    ranks outnumber the cards (here there is none); the one-device launcher
    defaults to the card."""
    cards = torch.cuda.device_count()
    for flags in (["--data", str(cards + 2)], ["--model", str(cards + 2)]):
        with pytest.raises(SystemExit, match="--backend nccl needs a card a rank"):
            train_launch.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--backend",
                               "nccl"] + flags)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train_launch.main(["--arch", ARCH, "--smoke", "--steps", "1"])


def test_train_resilient_example_recovers(capsys):
    """The twin of ``examples/train_resilient.py``, shortened: the reduced
    jamba fails before step 3 and resumes from its step-2 checkpoint."""
    from repro_torch.examples import train_resilient

    out = train_resilient.main(["--device", "cpu", "--steps", "4", "--ckpt-every", "2",
                                "--fail-at", "3", "--log-every", "1"])
    assert [h["step"] for h in out["history"]] == [0, 1, 2, 2, 3]
    assert "recovered from the step-2 checkpoint" in capsys.readouterr().out


def test_train_launcher_spawns_gloo_ranks_on_the_cpu(tmp_path, capfd):
    """``--data 2`` on the CPU: two gloo ranks, FSDP, a checkpoint of the
    global tree that the one-device trainer restores."""
    train_launch.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--backend", "gloo",
                       "--data", "2", "--steps", "2", "--seq-len", "8", "--global-batch", "4",
                       "--ckpt-dir", str(tmp_path)])
    out = capfd.readouterr().out
    assert "2 ranks" in out and "step     1" in out
    cfg = get_smoke_config(ARCH)
    tree, extra = ckpt.restore(str(tmp_path))
    assert extra == {"step": 2}
    params, _ = trainer_lib.state_from_tree(tree, cfg, "cpu", "f32")
    assert tree_lib.leaves(params)[0].shape[-1] == cfg.d_model
