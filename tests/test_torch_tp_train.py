"""Training MLA, MoE, Mamba and cross layers over a device mesh: the port's
ranks against the reference's sharded train step on the CPU.

The port's ranks are separate processes (``tests/_torch_tp_train_rank.py``,
which imports only ``repro_torch``), joined by a gloo process group on
``localhost`` over a ``(data, model)`` mesh: one spawn a part of
``PARTS``, each its own once-a-session computation (``_torch_once``), so
that a part's tests wait for that part alone.  Both packages train the
port's ``materialize(cfg, tp=model)`` weights, every leaf that
initialises to ones or zeros (norms, cross gates, ``D``, ``conv_b``)
drawn off its init, in the reference's layout.  The reference's side is
its jitted ``make_train_step`` on an Auto-typed mesh of the same shape
(``tests/test_torch_distributed.py``'s pattern), its parameters placed by
``P.shardings`` under ``base_rules(fsdp=True)`` (the experts over the
model axis where they divide it, else their hidden width), its batch by
``shard_batch``; its first step's global gradients are those its
optimizer is given (a wrapper keeps them in the state).

The parts: deepseek-v2-lite-16b (MLA with a full-rank query, a dense
prefix layer, MoE with shared experts) at ``(1, 2)``, at ``(2, 2)`` (four
ranks: FSDP, TP and the global aux loss) and at ``(2, 1)`` with two
microbatches (each microbatch's aux over its global rows); minicpm3-4b
(low-rank query) and mixtral-8x7b (expert-sharded MoE, sliding window) at
``(1, 2)``; mixtral at ``(1, 3)``, whose 4 experts the model axis does not
divide (their hidden width sharded); falcon-mamba-7b,
llama-3.2-vision-11b, seamless-m4t-medium (the encoder, cross layers over
its output) and jamba-1.5-large-398b at ``(1, 2)``.

Held, each part: the first step's loss and metrics within 1e-5, its global
gradients within 1e-5 of each leaf's largest |value|; the parameters after
two steps within 1e-5 of each leaf's largest but for the elements Adam's
first steps move by sign(g) (counted, at most 2 · lr a step, at most
1e-3 of the elements); every leaf no mesh axis shards bitwise equal on
every rank; each step's collectives, by kind in count and raw bytes,
equal to ``dryrun.train_step_collectives``' count; each rank's parameter
shards and optimizer state equal to ``dryrun.rank_bytes``'.  In process:
the aux loss of two data ranks' halves of a batch summed is the
reference's aux of the whole batch.
"""

import json
import os
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
from jax.sharding import AxisType

import _torch_tp_train_rank as R
from _torch_once import once_a_session
from repro.configs import get_smoke_config as ref_smoke_config
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import SyntheticLM as RefSyntheticLM
from repro.data.pipeline import shard_batch as ref_shard_batch
from repro.models import model as ref_model
from repro.models import moe as ref_moe
from repro.optim import adamw as ref_adamw
from repro.sharding import partitioning as RP
from repro.train.trainstep import TrainStepConfig as RefStepConfig
from repro.train.trainstep import make_train_step as ref_make_train_step
from repro_torch import configs, convert
from repro_torch.models import model as model_lib
from repro_torch.models import moe
from repro_torch.sharding import partitioning as P

jax.config.update("jax_platform_name", "cpu")

HERE = Path(__file__).resolve().parent
#: seconds a spawned set of ranks may take
JOIN_S = 300
#: the loss, the metrics and each gradient leaf (relative to its largest
#: |value|): float32 sums over ranks and over another order of products
RTOL = 1e-5
#: the share of parameter elements Adam's sign(g) may move past RTOL
FLIP_TOL = 1e-3
PARTS = list(R.PARTS)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


def _ref_cfg(arch, tp):
    return R.cfg_for(arch, tp, (ref_smoke_config, jnp.float32))


def _port_cfg(arch, tp):
    return R.cfg_for(arch, tp, (configs.get_smoke_config, torch.float32))


def _rules(cfg, tp):
    return RP.base_rules(fsdp=True, data_axes=("data",),
                         shard_experts=not cfg.n_experts or cfg.n_experts % tp == 0)


def _numpy_params(arch, tp) -> dict:
    """Seeded float weights of ``specs(cfg, tp)`` in the reference's layout,
    every leaf that initialises to ones or zeros drawn off its init."""
    cfg = _port_cfg(arch, tp)
    params = model_lib.materialize(cfg, seed=0, device="cpu", tp=tp)
    gen = torch.Generator().manual_seed(1)

    def off_init(leaf, spec):
        if spec.init in ("ones", "zeros"):
            leaf = leaf + 0.3 * torch.randn(leaf.shape, generator=gen)
        return leaf

    return convert.params_to_numpy(P.map_specs(params, model_lib.specs(cfg, tp), off_init), cfg)


def _keeping_grads(opt):
    """``opt`` whose state also keeps the last gradients it was given: the
    reference's sharded step then returns its global gradients (GSPMD's,
    after the microbatches' mean) in one compiled program."""

    def init(params):
        return opt.init(params), jax.tree_util.tree_map(
            lambda p: jnp.zeros(p.shape, jnp.float32), params)

    def update(grads, state, params):
        updates, inner = opt.update(grads, state[0], params)
        return updates, (inner, grads)

    return ref_adamw.Optimizer(init=init, update=update, init_abstract=opt.init_abstract)


def _reference(arch, shape, m, params, hosts) -> dict:
    """The reference's sharded step on the ``shape`` mesh over the batches:
    its first step's global gradients, and [(params, metrics) a step]."""
    tp = shape[1]
    cfg = _ref_cfg(arch, tp)
    mesh = jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:shape[0] * shape[1]])
    rules = _rules(cfg, tp)
    opt = _keeping_grads(ref_adamw.adamw(R.LR, moment_dtype="f32"))
    step = jax.jit(ref_make_train_step(cfg, opt, tp=tp, rules=rules, mesh=mesh,
                                       step_cfg=RefStepConfig(microbatches=m)))
    out: dict = {"steps": []}
    with jax.set_mesh(mesh):
        p = jax.device_put(params, RP.shardings(ref_model.specs(cfg, tp), mesh, rules))
        s = opt.init(p)
        for host in hosts:
            b = {k: jnp.asarray(v) for k, v in host.items()}
            p, s, met = step(p, s, ref_shard_batch(b, mesh, rules))
            out["steps"].append(jax.tree_util.tree_map(np.asarray, (p, met)))
            out.setdefault("grads", _flat(jax.tree_util.tree_map(np.asarray, s[1])))
    return out


def _run_part(tmp_path_factory, name):
    """Spawn the part's ranks, compute the reference's side meanwhile, join
    the ranks within :data:`JOIN_S` → (reference, [each rank's file])."""
    arch, shape, m = R.PARTS[name]
    world = shape[0] * shape[1]
    work = tmp_path_factory.mktemp(f"tp_train_{name}")
    tree = _numpy_params(arch, shape[1])
    np.savez(work / "params.npz", **_flat(tree))
    cfg = _ref_cfg(arch, shape[1])
    hosts = R.batches(RefSyntheticLM(RefDataConfig(vocab_size=cfg.vocab_size, **R.DATA)), cfg)
    np.savez(work / "batches.npz", **_flat({str(i): h for i, h in enumerate(hosts)}))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(HERE.parent / "src")] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    port, procs = _free_port(), []
    for rank in range(world):
        arg = json.dumps({"rank": rank, "world": world, "port": port, "workdir": str(work),
                          "arch": arch, "shape": list(shape), "microbatches": m})
        log = open(work / f"rank{rank}.log", "w")
        procs.append((subprocess.Popen([sys.executable, str(HERE / "_torch_tp_train_rank.py"),
                                        arg], env=env, stdout=log, stderr=subprocess.STDOUT),
                      log))
    t0 = time.monotonic()
    ref = _reference(arch, shape, m, jax.tree_util.tree_map(jnp.asarray, tree), hosts)
    for proc, log in procs:
        try:
            proc.wait(timeout=max(1.0, JOIN_S - (time.monotonic() - t0)))
        except subprocess.TimeoutExpired:
            for p, _ in procs:
                p.kill()
        log.close()
    logs = [(work / f"rank{r}.log").read_text()[-3000:] for r in range(world)]
    assert all(p.returncode == 0 for p, _ in procs), "\n".join(logs)
    ranks = []
    for r in range(world):
        with np.load(work / f"rank{r}.npz") as z:
            ranks.append({k: z[k] for k in z.files})
    return ref, ranks


@pytest.fixture(scope="module")
def runs(request, tmp_path_factory):
    """``runs(part)`` → (reference, [rank results]) of one of :data:`PARTS`,
    computed once a session."""
    done: dict = {}

    def get(name):
        if name not in done:
            done[name] = once_a_session(request, tmp_path_factory, f"test_torch_tp_train_{name}",
                                        lambda: _run_part(tmp_path_factory, name))
        return done[name]

    return get


def _leaf_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("name", PARTS)
def test_first_step_loss_metrics_and_gradients_match_reference(runs, name):
    ref, ranks = runs(name)
    want = ref["steps"][0][1]
    for r in ranks:
        for k in ("loss", "ce", "aux", "z", "tokens", "grad_norm"):
            w = float(want[k])
            assert abs(float(r[f"step0/{k}"]) - w) <= RTOL * abs(w), (k, float(r[f"step0/{k}"]),
                                                                      w)
    arch, shape, _ = R.PARTS[name]
    cfg = _port_cfg(arch, shape[1])
    assert (float(want["aux"]) > 0) == any(cfg.ffn_kind(i) == "moe"
                                           for i in range(cfg.n_layers))
    for key, w in ref["grads"].items():
        # every leaf the loss reaches: all but an encoder-decoder's (ungated) cross gate
        assert np.abs(w).max() > 0 or (cfg.is_enc_dec and key.endswith("cross/gate")), key
        assert _leaf_err(ranks[0][f"grads/{key}"], w) <= RTOL, key


@pytest.mark.parametrize("name", PARTS)
def test_two_steps_match_reference(runs, name):
    """The parameters after each step within RTOL of each leaf's largest
    |value| but for Adam's sign(g) elements (a gradient within rounding of
    zero), counted and printed."""
    ref, ranks = runs(name)
    got = ranks[0]
    signs = n = 0
    for i, (p, met) in enumerate(ref["steps"]):
        for k in ("loss", "ce", "aux", "z"):
            w = float(met[k])
            assert abs(float(got[f"step{i}/{k}"]) - w) <= RTOL * abs(w), (i, k)
        for key, w in _flat(p).items():
            g = np.asarray(got[f"step{i}/state/params/{key}"], np.float64)
            w = np.asarray(w, np.float64)
            d = np.abs(g - w)
            loose = d > RTOL * np.abs(w).max()
            assert (d[loose] <= 2 * R.LR * (i + 1) * (1 + 1e-3)).all(), (name, i, key, d.max())
            signs, n = signs + int(loose.sum()), n + w.size
    print(f"{name}: {signs} of {n} parameter elements past {RTOL} of their leaf's largest")
    assert signs <= FLIP_TOL * n, signs


@pytest.mark.parametrize("name", PARTS)
def test_replicated_leaves_bitwise_equal_on_every_rank(runs, name):
    _, ranks = runs(name)
    keys = [k for k in ranks[0] if k.startswith("replicated/")]
    assert keys
    for r in ranks[1:]:
        for k in keys:
            assert np.array_equal(r[k], ranks[0][k]), k


@pytest.mark.parametrize("name", PARTS)
def test_step_collectives_equal_the_dry_run(runs, name):
    """Every step on every rank: the collectives recorded, by kind in count
    and raw bytes, are ``dryrun.train_step_collectives``' count (the MoE
    router's and combine's all-reduces, the gates', MLA's and Mamba's
    ``copy_to`` gradients, the encoder's and the cross layers', the aux
    loss's counts, FSDP's gathers)."""
    _, ranks = runs(name)
    for files in ranks:
        steps = [k for k in files if k.endswith("/collectives")]
        assert len(steps) == R.STEPS
        for key in steps:
            have, want = json.loads(str(files[key]))
            assert have == want and have, key


@pytest.mark.parametrize("name", PARTS)
def test_rank_state_bytes_equal_the_dry_run(runs, name):
    _, ranks = runs(name)
    for files in ranks:
        have, want = json.loads(str(files["bytes"]))
        assert have == want


def test_rank_script_imports_neither_jax_nor_repro():
    """The spawned rank, with the modules it runs, stays clear of JAX and the
    reference."""
    probe = ("import sys; sys.path.insert(0, %r); import _torch_tp_train_rank\n"
             "from repro_torch.train import trainstep\n"
             "from repro_torch.launch import dryrun\n"
             "print(','.join(sorted(m for m in sys.modules if m == 'jax' or "
             "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))))" % str(HERE))
    env = dict(os.environ, PYTHONPATH=str(HERE.parent / "src"))
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         env=env, timeout=120, check=True)
    assert out.stdout.strip() == ""


def test_aux_of_split_batch_halves_equals_reference_whole_batch():
    """Two data ranks' halves of a batch: each rank's share of the aux loss,
    over the top-1 counts of both halves, summed is the reference's aux
    over the whole batch (deepseek's smoke router, float32)."""
    arch = "deepseek-v2-lite-16b"
    cfg, rcfg = _port_cfg(arch, 1), _ref_cfg(arch, 1)
    rng = np.random.default_rng(4)
    router = rng.normal(size=(cfg.d_model, cfg.n_experts)).astype(np.float32)
    x = rng.normal(size=(4, 16, cfg.d_model)).astype(np.float32)
    _, _, want = ref_moe._route({"router": jnp.asarray(router)}, jnp.asarray(x), rcfg)
    params = {"router": torch.from_numpy(router)}
    halves = [torch.from_numpy(x[:2]), torch.from_numpy(x[2:])]
    local = []
    for h in halves:  # each half's own top-1 counts
        moe._route(params, h, cfg, global_counts=lambda c: (local.append(c) or c, 2))
    shares = [moe._route(params, h, cfg, global_counts=lambda c: (local[0] + local[1], 2))[2]
              for h in halves]
    whole = moe._route(params, torch.from_numpy(x), cfg)[2]
    assert abs(float(sum(shares)) - float(want)) <= RTOL * abs(float(want))
    assert abs(float(whole) - float(want)) <= RTOL * abs(float(want))
    assert abs(float(shares[0]) - float(want)) > RTOL * abs(float(want))  # a half's share alone
