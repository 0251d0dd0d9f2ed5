"""The engine's data axis and sequence-parallel KV decode against the
reference on the CPU.

The port's ranks are separate processes (``tests/_torch_data_rank.py``,
which imports only ``repro_torch``), joined by a gloo process group on
``localhost`` over a ``(data, model)`` mesh of 2 × 1 or 2 × 2 ranks: one
spawn a case (part, mesh, config), each its own once-a-session
computation (``_torch_once``), so that a case's tests wait for that case
alone.  Both packages run the port's ``materialize(cfg, tp=model)`` weights
in the reference's stacked layout, every leaf that initialises to ones or
zeros drawn off its init.  The reference runs here on an Auto-typed mesh
of the same shape, its jobs spread over a few threads while the ranks run.

Held, the engine over the data axis (``part`` ``"serve"``): the
teacher-forced schedule of ``_torch_tp_rank.schedule`` on 4 slots, 2 a
data rank (its refill group split 2 + 1), against the reference's
``ServeEngine`` under ``base_rules(data_axes=("data",))``:
qwen3-1.7b's smoke config on ``w8a8`` and path A's stack under ``fcfs``
and ``w8a8`` under ``token_budget:budget=8`` at (2, 1) and (2, 2), and
deepseek-v2-lite-16b's (MLA + MoE) and falcon-mamba-7b's (refills one
request at a time) on ``w8a8`` at (2, 1) — the trace's kinds and the
tokens equal, the logits within 1e-4 of the largest (float32), every
rank's results equal, each rank's collectives (the model axis's, the data
axis's gathers of ids and logits, the closing token check) by kind in count
and raw bytes equal to ``dryrun.serve_collectives``, its resident bytes
(its block of the cache) to ``dryrun.rank_bytes``, and at (2, 1) the
logits within 1e-5 of data = 1's on the same weights.

Held, sequence-parallel decode (``part`` ``"seq"``): ``plan(cfg,
SHAPES["long_500k"], mesh)`` rules (``batch: ()``, ``kv_seq: ("data",)``);
a prompt prefilled whole on each rank, its cache cut to the rank's block
of the ring (``partitioning.shard_caches``), then three ``decode_step``
calls, against the reference's ``decode_step`` jitted under the same
rules on caches placed by its ``cache_pspecs``: mixtral-8x7b's (its
window-long ring of 32) and jamba-1.5-large-398b's smoke configs at (2, 1)
and mixtral's at (2, 2), a prompt of 40 tokens (the ring wrapped) on the
float, ``w8a8`` and path A stacks and one of 6 (rank 1's block wholly
masked) on the float stack — within 1e-5 of the largest logit in float32
(``w8a8``'s and path A's activation codes forced to the reference's at
rounding boundaries, recorded by an ordered ``jax.debug.callback`` in a
one-device drive, as ``BoundaryCodes`` does), every rank's logits equal,
each decode call's collectives equal to ``dryrun.call_collectives``'
count under the plan's rules, the rank's bytes to ``dryrun.rank_bytes``
of that plan, and the cut equal to the rank's block of the whole ring.
"""

import json
import os
import socket
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType, NamedSharding, PartitionSpec

import _torch_data_rank as D
import _torch_tp_rank as R
from _torch_once import once_a_session
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_smoke_config as ref_smoke_config
from repro.core import quant as ref_quant
from repro.launch.mesh import plan as ref_plan
from repro.models import model as ref_model
from repro.models.attention import attn_dims as ref_attn_dims
from repro.serve import engine as ref_engine
from repro.sharding import partitioning as RP
from repro_torch import configs, convert
from repro_torch.models import model as model_lib
from repro_torch.sharding import partitioning as P

SERVE_CASES = [((2, 1), arch) for arch in D.SERVES] + [((2, 2), "qwen3-1.7b")]
SEQ_CASES = [((2, 1), "mixtral-8x7b"), ((2, 1), "jamba-1.5-large-398b"),
             ((2, 2), "mixtral-8x7b")]
PARTS = [("serve", shape, arch) for shape, arch in SERVE_CASES] + \
    [("seq", shape, arch) for shape, arch in SEQ_CASES]
SERVED = [(shape, arch, stack, sched) for shape, arch in SERVE_CASES
          for stack, sched in D.SERVES[arch]]
#: seconds a spawned set of ranks may take
JOIN_S = 400
#: threads the reference's jobs are spread over
REF_THREADS = 4
SERVE_RTOL = 1e-4
SEQ_RTOL = 1e-5
NEG_INF = float(np.float32(-1e30))
HERE = Path(__file__).resolve().parent


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


def _ref_cfg(arch):
    return D.cfg_for(arch, (ref_smoke_config, jnp.float32))


def _port_cfg(arch):
    return D.cfg_for(arch, (configs.get_smoke_config, torch.float32))


def _mesh(shape):
    return jax.make_mesh(shape, ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:shape[0] * shape[1]])


def _serve_rules(cfg, tp):
    return RP.base_rules(data_axes=("data",), shard_kv_heads=ref_attn_dims(cfg, tp)[2],
                         shard_experts=not cfg.n_experts or cfg.n_experts % tp == 0)


def _numpy_params(arch, tp) -> dict:
    """Seeded float weights of ``specs(cfg, tp)`` in the reference's layout,
    every leaf that initialises to ones or zeros drawn off its init."""
    cfg = _port_cfg(arch)
    params = model_lib.materialize(cfg, seed=0, device="cpu", tp=tp)
    gen = torch.Generator().manual_seed(1)

    def off_init(leaf, spec):
        if spec.init in ("ones", "zeros"):
            leaf = leaf + 0.3 * torch.randn(leaf.shape, generator=gen)
        return leaf

    return convert.params_to_numpy(P.map_specs(params, model_lib.specs(cfg, tp), off_init), cfg)


def _ref_serve(arch, shape, params, stack, sched) -> dict:
    """The reference engine's teacher-forced serve on the ``shape`` mesh, its
    slots over ``data``."""
    cfg, tp = _ref_cfg(arch), shape[1]
    mode, cache = R.STACKS[stack]
    mesh, rules = _mesh(shape), _serve_rules(cfg, tp)
    with jax.set_mesh(mesh):
        placed = jax.device_put(params, RP.shardings(ref_model.specs(cfg, tp), mesh, rules))
        eng = ref_engine.ServeEngine(placed, cfg, tp=tp, rules=rules, slots=D.SLOTS,
                                     max_len=D.MAX_LEN, mode=mode, cache_format=cache,
                                     scheduler=sched, min_dim=D.MIN_DIM, trace_logits=True)
        reqs = R.schedule(eng, cfg.vocab_size)
    return {"tokens": np.array([t for r in reqs for t in r.out]),
            "logits": np.concatenate([np.reshape(np.asarray(lg), (-1, lg.shape[-1]))
                                      for _, _, lg in eng.logit_trace]),
            "kinds": np.array([f"{k}{list(s)}" for k, s, _ in eng.logit_trace])}


#: the list the recording ``quantize`` of the tracing thread appends to
_RECORD = threading.local()
_QUANTIZE = ref_quant.quantize


def _recording_quantize(x, *, bits=8, axis=-1, scale=None):
    qt = _QUANTIZE(x, bits=bits, axis=axis, scale=scale)
    log = getattr(_RECORD, "codes", None)
    if log is not None:  # bound at trace time, in the thread that traces
        jax.debug.callback(lambda v, q: log.append((np.asarray(v), np.asarray(q))),
                           x / qt.scale, qt.data, ordered=True)
    return qt


def _ref_seq(arch, shape, params, stack, case, *, mesh=True, codes=None):
    """The reference's prefill of the case's prompt and three decode steps →
    logits ``[4, 1, V]``: on the mesh, its parameters placed and its decode
    jitted under ``plan``'s ``long_500k`` rules on caches placed by
    ``cache_pspecs``; or (``mesh=False``) on one device with the same
    weights, its roundings appended to ``codes``."""
    cfg, tp = _ref_cfg(arch), shape[1]
    mode, cache = R.STACKS[stack]
    prompt, steps = D.seq_inputs(cfg.vocab_size, case)
    mesh_ = _mesh(shape)
    rules = ref_plan(cfg, REF_SHAPES["long_500k"], mesh_).rules if mesh else None

    def go(p):
        if mode != "bf16":
            p = jax.jit(lambda w: ref_engine.convert_params(w, cfg, mode, min_dim=D.MIN_DIM))(p)
        run_cfg = cfg.scaled(cache_format=cache)
        prefill = jax.jit(lambda w, b: ref_model.prefill(w, b, run_cfg, tp=tp,
                                                         max_len=D.MAX_LEN, impl="jnp"))
        decode = jax.jit(lambda w, tok, c, q: ref_model.decode_step(
            w, tok, c, q, run_cfg, tp=tp, rules=rules, impl="jnp"))
        _RECORD.codes = codes
        try:
            logits, caches = prefill(p, {"tokens": jnp.asarray(prompt)})
            if mesh:
                specs = RP.cache_pspecs(caches, rules, ref_attn_dims(cfg, tp)[2], run_cfg)
                caches = jax.device_put(caches, jax.tree.map(
                    lambda s: NamedSharding(mesh_, s), specs,
                    is_leaf=lambda s: isinstance(s, PartitionSpec)))
            rows = [np.asarray(logits[:, -1])]
            for i, tok in enumerate(steps):
                logits, caches = decode(p, jnp.asarray(tok[:, None]), caches,
                                        jnp.asarray([prompt.shape[1] + i], jnp.int32))
                rows.append(np.asarray(logits[:, -1]))
            jax.effects_barrier()
        finally:
            _RECORD.codes = None
        return np.stack(rows)

    if not mesh:
        return go(params)
    with jax.set_mesh(mesh_):
        return go(jax.device_put(params, RP.shardings(ref_model.specs(cfg, tp), mesh_,
                                                      rules)))


def _write_codes(work, name, codes) -> None:
    np.savez(work / f"codes_{name}.tmp.npz", **{f"{n}{i}": a for i, (v, q) in enumerate(codes)
                                                for n, a in (("v", v), ("q", q))})
    os.replace(work / f"codes_{name}.tmp.npz", work / f"codes_{name}.npz")


@pytest.fixture(scope="module")
def runs(request, tmp_path_factory):
    """``runs(part, shape, arch)`` → (reference, [rank results]) of one of
    :data:`PARTS` (:func:`_run_case`), computed once a session."""
    done: dict = {}

    def get(part, shape, arch):
        key = part, shape, arch
        if key not in done:
            name = f"test_torch_data_axis_{part}_{shape[0]}x{shape[1]}_{arch}"
            done[key] = once_a_session(request, tmp_path_factory, name,
                                       lambda: _run_case(tmp_path_factory, *key))
        return done[key]

    return get


def _run_case(tmp_path_factory, part, shape, arch):
    """Spawn the mesh's ranks running ``part`` of ``arch``, compute the
    reference's meanwhile (the boundary codes first: the ranks wait for
    them), then join the ranks within ``JOIN_S``."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(HERE.parent / "src")] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    world = shape[0] * shape[1]
    work = tmp_path_factory.mktemp(f"data_{part}_{shape[0]}x{shape[1]}_{arch}")
    tree = _numpy_params(arch, shape[1])
    np.savez(work / f"{arch}.npz", **_flat(tree))
    params = jax.tree.map(jnp.asarray, tree)
    port = _free_port()
    procs = []
    for rank in range(world):
        arg = json.dumps({"rank": rank, "world": world, "port": port, "workdir": str(work),
                          "shape": list(shape), "arch": arch, "part": part})
        log = open(work / f"rank{rank}.log", "w")
        procs.append((subprocess.Popen([sys.executable, str(HERE / "_torch_data_rank.py"), arg],
                                       env=env, stdout=log, stderr=subprocess.STDOUT), log))
    t0 = time.monotonic()

    def codes_job(stack, case):
        codes: list = []
        _ref_seq(arch, shape, params, stack, case, mesh=False, codes=codes)
        _write_codes(work, f"{arch}_{stack}_{case}", codes)

    ref_quant.quantize = _recording_quantize
    try:
        with ThreadPoolExecutor(REF_THREADS) as pool:
            if part == "serve":
                jobs = {(stack, sched): pool.submit(_ref_serve, arch, shape, params, stack,
                                                    sched)
                        for stack, sched in D.SERVES[arch]}
            else:
                coded = [pool.submit(codes_job, stack, case) for case, stack in D.SEQ_CASES
                         if stack in R.CODED]
                jobs = {(case, stack): pool.submit(_ref_seq, arch, shape, params, stack, case)
                        for case, stack in D.SEQ_CASES}
                for job in coded:
                    job.result()
            ref = {k: job.result() for k, job in jobs.items()}
    finally:
        ref_quant.quantize = _QUANTIZE
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


def _close(want, got, vocab):
    """Max error over the real logits ÷ their largest magnitude, and whether
    every pad logit is exactly NEG_INF in both."""
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    err = np.abs(want[..., :vocab] - got[..., :vocab]).max() / np.abs(want[..., :vocab]).max()
    pads = bool((want[..., vocab:] == NEG_INF).all() and (got[..., vocab:] == NEG_INF).all())
    return err, pads


@pytest.mark.parametrize("shape,arch,stack,sched", SERVED)
def test_serve_matches_reference(runs, shape, arch, stack, sched):
    ref, ranks = runs("serve", shape, arch)
    want, key = ref[(stack, sched)], f"{stack}/{sched}"
    assert list(want["kinds"]) == list(ranks[0][f"{key}/kinds"])
    assert np.array_equal(want["tokens"], ranks[0][f"{key}/tokens"])
    err, pads = _close(want["logits"], ranks[0][f"{key}/logits"], _port_cfg(arch).vocab_size)
    assert err < SERVE_RTOL and pads, (err, pads)


@pytest.mark.parametrize("part,shape,arch", PARTS)
def test_every_rank_computes_the_same(runs, part, shape, arch):
    """Every result but each rank's own: the count of codes forced (a
    row-parallel rounding holds the rank's features of each row), a serve's
    model calls and their collectives (a rank prefills its own slots'
    refills alone), and the rank's block of a ring."""
    _, ranks = runs(part, shape, arch)
    own = ("/codes", "/masked", "/cut_pos") + (("/model_calls", "/collectives")
                                               if part == "serve" else ())
    for other in ranks[1:]:
        assert set(other) == set(ranks[0])
        for key in other:
            if not key.endswith(own):
                assert np.array_equal(ranks[0][key], other[key]), key


@pytest.mark.parametrize("shape,arch,stack,sched", SERVED)
def test_serve_collectives_equal_the_dry_run(runs, shape, arch, stack, sched):
    """The model axis's collectives, the data axis's gathers of each round
    (ids, and logits under ``trace_logits``) and the closing token check
    over both axes, by kind in count and raw bytes, on every rank."""
    _, ranks = runs("serve", shape, arch)
    for r in ranks:
        have, want = json.loads(str(r[f"{stack}/{sched}/collectives"]))
        assert have == want and dict(have)["all-gather"][0] > 0
        calls, rounds = r[f"{stack}/{sched}/model_calls"]
        assert 1 <= calls <= rounds  # a rank makes no model call in a round it owns no row of


@pytest.mark.parametrize("shape,arch,stack,sched", SERVED)
def test_serve_rank_bytes_equal_the_dry_run(runs, shape, arch, stack, sched):
    """A rank's weights are the whole tree's (replicated over ``data``) at
    its model shards, its caches its block of ``slots / ways`` rows."""
    _, ranks = runs("serve", shape, arch)
    for r in ranks:
        weights, cache, twin_weights, twin_cache = r[f"{stack}/{sched}/bytes"]
        assert weights == twin_weights and cache == twin_cache and cache > 0


@pytest.mark.parametrize("arch,stack", [("qwen3-1.7b", "w8a8"), ("qwen3-1.7b", "A"),
                                        ("deepseek-v2-lite-16b", "w8a8"),
                                        ("falcon-mamba-7b", "w8a8")])
def test_data_axis_serve_equals_one_data_way(runs, arch, stack):
    """At (2, 1) the serve is data = 1's on the same weights, within 1e-5 of
    the largest logit (a rank's batch is half the rows: the CPU's float
    kernels may sum in another order)."""
    _, ranks = runs("serve", (2, 1), arch)
    key = f"{stack}/fcfs"
    err, _ = _close(ranks[0][f"{key}/data1_logits"], ranks[0][f"{key}/logits"],
                    _port_cfg(arch).vocab_size)
    assert err < SEQ_RTOL, err


@pytest.mark.parametrize("case,stack", [(c, s) for c, s in D.SEQ_CASES])
@pytest.mark.parametrize("shape,arch", SEQ_CASES)
def test_seq_decode_matches_reference(runs, shape, arch, case, stack):
    ref, ranks = runs("seq", shape, arch)
    got = ranks[0][f"{case}/{stack}/logits"]
    err, pads = _close(ref[(case, stack)], got, _port_cfg(arch).vocab_size)
    assert err < SEQ_RTOL and pads, (err, pads)
    if stack in R.CODED:  # every reference rounding met, none far from its boundary
        calls, ref_calls, _, far = ranks[0][f"{case}/{stack}/codes"]
        assert calls == ref_calls and far == 0


@pytest.mark.parametrize("shape,arch", SEQ_CASES)
def test_seq_decode_collectives_equal_the_dry_run(runs, shape, arch):
    """Each decode call's collectives: the combine's MAX and SUM a GQA layer
    over ``data``, and at tp = 2 the model axis's, as counted."""
    _, ranks = runs("seq", shape, arch)
    cfg = _port_cfg(arch)
    attn = sum(cfg.mixer_kind(i) == "attn" for i in range(cfg.n_layers))
    for r in ranks:
        for case, stack in D.SEQ_CASES:
            calls = json.loads(str(r[f"{case}/{stack}/collectives"]))
            assert len(calls) == D.DECODE_STEPS
            for have, want in calls:
                assert have == want and dict(have)["all-reduce"][0] >= 2 * attn


@pytest.mark.parametrize("shape,arch", SEQ_CASES)
def test_seq_decode_rank_holds_its_block(runs, shape, arch):
    """The rank's bytes equal ``rank_bytes`` of the plan (each ring half the
    one-device ring's), its cut of the ring is its block of the whole one,
    and the short prompt leaves every ring of rank 1 empty."""
    _, ranks = runs("seq", shape, arch)
    for r in ranks:
        for case, stack in D.SEQ_CASES:
            weights, cache, twin_weights, twin_cache = r[f"{case}/{stack}/bytes"]
            assert weights == twin_weights and cache == twin_cache
    index = [0, 1] if shape[1] == 1 else [0, 0, 1, 1]  # the data coordinate of each rank
    whole = np.concatenate([ranks[index.index(d)]["long/float/cut_pos"] for d in (0, 1)], 1)
    assert sorted(whole[whole >= 0].tolist()) == list(range(40 - D.MAX_LEN, 40))
    assert bool(ranks[-1]["short/float/masked"].all())
    assert not bool(ranks[0]["short/float/masked"].any())
