"""Tensor-parallel serving of Mamba and cross-attention layers against the
reference on the CPU.

The smoke configs of falcon-mamba-7b (2 Mamba layers, d_inner 128),
jamba-1.5-large-398b (8 layers: attention at layer 4, Mamba elsewhere, MoE
on the odd layers), llama-3.2-vision-11b (layer 3 cross-attends to 17 patch
embeddings under a tanh gate) and seamless-m4t-medium (2 non-causal encoder
layers over 24 frames, 2 decoder layers self- then cross-attending), in
float32, at tp = 2; llama-3.2-vision-11b also at tp = 3, its FFN 96 wide
(the smoke config's 256 fused columns do not divide three ways), so that
its heads pad 4 → 6, its KV heads 2 → 3 and the vocab 512 → 513.  Every
leaf that initialises to ones or zeros (norms, LayerNorm biases, the cross
gates, ``D``, ``conv_b``) is drawn off its init, so that a dropped term
shows and the cross branch is open.  Weights of 8 or more rows and columns
convert (``min_dim`` 8), so that ``x_proj`` (128 × 12) runs its
row-parallel integer path under ``w8a8``.

The port's ranks are separate processes (``tests/_torch_tp_rank.py`` with
``"suite": "hybrid"``, which imports only ``repro_torch``), joined by a
gloo process group on ``localhost``: one spawn per case (world size and
config) for its drives, and one for a served config's engine serves.  Both
packages serve the same float weights (the port's ``materialize(cfg,
tp=...)`` in the reference's stacked layout), with the same seeded
contexts.  The reference runs here on an Auto-typed ``(data=1, model=tp)``
mesh under ``base_rules``, its drives spread over a few threads while the
ranks run; each case's spawn and drives run once a test session
(``_torch_once``).

Held: ``model.prefill`` and three ``decode_step`` calls on the float,
``w8a8`` and path A stacks within 1e-4 of the reference's largest logit,
every pad logit exactly ``NEG_INF`` (``w8a8``'s int8 and path A's int4
activation codes forced to the reference's at rounding boundaries, recorded
by an ordered ``jax.debug.callback`` in a one-device drive of the
tp-shaped weights); the teacher-forced engine serves of
falcon-mamba and jamba on ``w8a8`` and path A under ``fcfs``; every rank's
results equal; ``w8a8`` at tp = 2 equal to tp = 1 bit for bit; each rank's
weight and cache bytes (the Mamba state, the context K/V) equal to
``dryrun.rank_bytes``; every prefill's, decode step's and serve's
collectives, by kind in count and raw bytes, equal to the dry run's count.
Planted faults fail: ``x_proj``'s partials left unreduced, a rank's cross
queries paired with another rank's KV heads, the encoder made causal.  In
process: ``materialize_converted(..., mesh=)`` equal to slicing the whole
conversion, and the refusals (falcon-mamba at tp = 3, training these
layers at tp).
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
from jax.sharding import AxisType

import _torch_tp_rank as R
from _torch_once import once_a_session
from repro.configs import get_smoke_config as ref_smoke_config
from repro.core import quant as ref_quant
from repro.models import model as ref_model
from repro.models.attention import attn_dims as ref_attn_dims
from repro.serve import engine as ref_engine
from repro.sharding import partitioning as RP
from repro_torch import configs, convert
from repro_torch.distributed.mesh import TensorParallel
from repro_torch.launch import dryrun
from repro_torch.models import model as model_lib
from repro_torch.sharding import partitioning as P

CASES = [(tp, arch) for tp, archs in R.HYBRID_WORLDS.items() for arch in archs]
#: what a spawn computes: a case's drives ("pd"), or a served config's engine
#: serves at tp = 2 ("serve")
PARTS = [(tp, arch, "pd") for tp, arch in CASES] + [(2, arch, "serve")
                                                   for arch in R.HYBRID_SERVED]
MAMBA, JAMBA, VLM, ENC_DEC = R.HYBRID_ARCHS
#: seconds a spawned set of ranks may take
JOIN_S = 400
#: threads the reference's drives are spread over
REF_THREADS = 4
LOGIT_RTOL = 1e-4
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


def _ref_cfg(arch, tp):
    return R.hybrid_cfg(arch, tp, (ref_smoke_config, jnp.float32))


def _port_cfg(arch, tp):
    return R.hybrid_cfg(arch, tp, (configs.get_smoke_config, torch.float32))


def _rules(rp, cfg, tp):
    return rp.base_rules(data_axes=("data",), shard_kv_heads=ref_attn_dims(cfg, tp)[2],
                         shard_experts=not cfg.n_experts or cfg.n_experts % tp == 0)


def _mesh(tp):
    return jax.make_mesh((1, tp), ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:tp])


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


def _placed(arch, tp, params):
    cfg = _ref_cfg(arch, tp)
    return jax.device_put(params, RP.shardings(ref_model.specs(cfg, tp), _mesh(tp),
                                               _rules(RP, cfg, tp)))


def _ref_drive(arch, tp, params, stack, *, mesh=True, codes=None):
    """The reference's prefill (with the context) and three decode steps →
    logits ``[4, 2, V]``; on the mesh, or (``mesh=False``) on one device
    with the tp-shaped weights, its roundings appended to ``codes``."""
    cfg = _ref_cfg(arch, tp)
    mode, cache = R.STACKS[stack]
    rules = _rules(RP, cfg, tp) if mesh else None
    toks, pos, steps, step_pos = R.prefill_inputs(cfg.vocab_size)
    batch = {"tokens": jnp.asarray(toks), "positions": jnp.asarray(pos),
             **{k: jnp.asarray(a) for k, a in R.hybrid_context(cfg).items()}}

    def go(placed):
        if mode != "bf16":
            placed = jax.jit(lambda p: ref_engine.convert_params(
                p, cfg, mode, min_dim=R.HYBRID_MIN_DIM))(placed)
        eng = ref_engine.ServeEngine(placed, cfg, tp=tp, rules=rules, slots=2, max_len=R.MAX_LEN,
                                     cache_format=cache, min_dim=R.HYBRID_MIN_DIM)
        prefill = jax.jit(lambda p, b: ref_model.prefill(
            p, b, eng.cfg, tp=tp, max_len=R.MAX_LEN, rules=rules, impl="jnp"))
        decode = jax.jit(lambda p, tok, c, q: ref_model.decode_step(
            p, tok, c, q, eng.cfg, tp=tp, rules=rules, impl="jnp"))
        _RECORD.codes = codes
        try:
            logits, caches = prefill(eng.params, batch)
            rows = [np.asarray(logits[:, -1])]
            for tok, p in zip(steps, step_pos):
                logits, caches = decode(eng.params, jnp.asarray(tok[:, None]), caches,
                                        jnp.asarray(p))
                rows.append(np.asarray(logits[:, -1]))
            jax.effects_barrier()
        finally:
            _RECORD.codes = None
        return np.stack(rows)

    if not mesh:
        return go(params)
    with jax.set_mesh(_mesh(tp)):
        return go(_placed(arch, tp, params))


def _ref_serve(arch, tp, params, stack) -> dict:
    """The reference's teacher-forced serve on the mesh."""
    cfg = _ref_cfg(arch, tp)
    mode, cache = R.STACKS[stack]
    with jax.set_mesh(_mesh(tp)):
        eng = ref_engine.ServeEngine(_placed(arch, tp, params), cfg, tp=tp,
                                     rules=_rules(RP, cfg, tp), slots=2, max_len=R.MAX_LEN,
                                     mode=mode, cache_format=cache,
                                     min_dim=R.HYBRID_MIN_DIM, trace_logits=True)
        reqs = R.schedule(eng, cfg.vocab_size)
    return {"tokens": np.array([t for r in reqs for t in r.out]),
            "logits": np.concatenate([np.reshape(np.asarray(lg), (-1, lg.shape[-1]))
                                      for _, _, lg in eng.logit_trace]),
            "kinds": np.array([f"{k}{list(s)}" for k, s, _ in eng.logit_trace])}


def _write_codes(work, name, codes) -> None:
    np.savez(work / f"codes_{name}.tmp.npz", **{f"{n}{i}": a for i, (v, q) in enumerate(codes)
                                                for n, a in (("v", v), ("q", q))})
    os.replace(work / f"codes_{name}.tmp.npz", work / f"codes_{name}.npz")


@pytest.fixture(scope="module")
def runs(request, tmp_path_factory):
    """``runs(tp, arch, part)`` → (reference, [rank results]) of one of
    :data:`PARTS` (:func:`_run_case`), computed once a session
    (``_torch_once``): the parts compute in whichever workers first need
    them, side by side, and a part's tests wait for that part alone."""
    done: dict = {}

    def get(tp, arch, part="pd"):
        key = tp, arch, part
        if key not in done:
            done[key] = once_a_session(request, tmp_path_factory,
                                       f"test_torch_tp_hybrid_{tp}_{arch}_{part}",
                                       lambda: _run_case(tmp_path_factory, *key))
        return done[key]

    return get


def _run_case(tmp_path_factory, tp, arch, part):
    """Spawn ``tp`` ranks running ``part`` of ``arch``, compute the
    reference's meanwhile (the drives' boundary codes first: the ranks wait
    for them), then join the ranks within ``JOIN_S`` → (``{stack: logits}``
    or ``{stack: trace}``, [rank results])."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(HERE.parent / "src")] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    work = tmp_path_factory.mktemp(f"hybrid_tp{tp}_{arch}_{part}")
    tree = _numpy_params(arch, tp)
    np.savez(work / f"{arch}.npz", **_flat(tree))
    params = jax.tree.map(jnp.asarray, tree)
    port = _free_port()
    procs = []
    for rank in range(tp):
        arg = json.dumps({"rank": rank, "world": tp, "port": port, "workdir": str(work),
                          "suite": "hybrid", "arch": arch, "part": part})
        log = open(work / f"rank{rank}.log", "w")
        procs.append((subprocess.Popen([sys.executable, str(HERE / "_torch_tp_rank.py"), arg],
                                       env=env, stdout=log, stderr=subprocess.STDOUT), log))
    t0 = time.monotonic()

    def codes_job(stack):
        codes: list = []
        _ref_drive(arch, tp, params, stack, mesh=False, codes=codes)
        _write_codes(work, f"{arch}_{stack}", codes)

    ref_quant.quantize = _recording_quantize
    try:
        with ThreadPoolExecutor(REF_THREADS) as pool:
            if part == "serve":
                jobs = {stack: pool.submit(_ref_serve, arch, tp, params, stack)
                        for stack in R.SERVED}
            else:
                codes = [pool.submit(codes_job, stack) for stack in R.CODED]
                jobs = {stack: pool.submit(_ref_drive, arch, tp, params, stack)
                        for stack in R.STACKS}
                for job in codes:
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
    logs = [(work / f"rank{r}.log").read_text()[-3000:] for r in range(tp)]
    assert all(p.returncode == 0 for p, _ in procs), "\n".join(logs)
    ranks = []
    for r in range(tp):
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


@pytest.mark.parametrize("stack", list(R.STACKS))
@pytest.mark.parametrize("tp,arch", CASES)
def test_prefill_decode_logits_match_reference(runs, tp, arch, stack):
    ref, ranks = runs(tp, arch)
    cfg = _port_cfg(arch, tp)
    got = ranks[0][f"{arch}/pd/{stack}" + ("_forced" if stack in R.CODED else "")]
    err, pads = _close(ref[stack], got, cfg.vocab_size)
    assert err < LOGIT_RTOL and pads, (err, pads)
    assert got.shape[-1] == model_lib.padded_vocab(cfg, tp)
    if stack in R.CODED:  # every reference rounding met, none far from its boundary
        calls, ref_calls, _, far = ranks[0][f"{arch}/pd/{stack}_codes"]
        assert calls == ref_calls and far == 0


@pytest.mark.parametrize("tp,arch,part", PARTS)
def test_every_rank_computes_the_same(runs, tp, arch, part):
    """Every result but the count of codes forced, which is each rank's own
    (a row-parallel rounding holds the rank's features of each row)."""
    _, ranks = runs(tp, arch, part)
    for other in ranks[1:]:
        assert set(other) == set(ranks[0])
        for key in other:
            if not key.endswith("_codes"):
                assert np.array_equal(ranks[0][key], other[key]), key


@pytest.mark.parametrize("arch", R.HYBRID_ARCHS)
def test_w8a8_tp2_is_bit_identical_to_one_device(runs, arch):
    """``x_proj``'s, ``out_proj``'s and every ``wo``'s and ``w_out``'s int32
    partials summed exactly, each row's amax MAX-reduced first: ``w8a8`` at
    tp = 2 is tp = 1's, through the Mamba layers, the cross layers and the
    encoder."""
    _, ranks = runs(2, arch)
    assert np.array_equal(ranks[0][f"{arch}/pd/w8a8"], ranks[0][f"{arch}/pd/w8a8_tp1"])


class _StandIn:
    def __init__(self, shape, names):
        self.axis_names, self.devices = names, np.empty(shape)


@pytest.mark.parametrize("stack", list(R.STACKS))
@pytest.mark.parametrize("tp,arch", CASES)
def test_resident_bytes_equal_the_dry_run(runs, tp, arch, stack):
    """Each rank's weight bytes, and its caches' after the prefill (the
    Mamba state of its channels, the context K/V of its KV heads, the rings
    of its KV heads), equal ``dryrun.rank_bytes``' count of a 2-slot decode
    cell, whose weights are the partitioning's ``local_bytes``."""
    _, ranks = runs(tp, arch)
    cfg = _port_cfg(arch, tp).scaled(cache_format=R.STACKS[stack][1])
    mode = R.STACKS[stack][0]
    rules = _rules(P, cfg, tp)
    twin = dryrun.rank_bytes(cfg, "decode", mesh_axes={"data": 1, "model": tp}, rules=rules,
                             qmode=mode, min_dim=R.HYBRID_MIN_DIM, batch=2, cache_len=R.MAX_LEN)
    assert twin["even"] and twin["cache"] > 0
    meta = dryrun.serve_params_meta(cfg, mode, min_dim=R.HYBRID_MIN_DIM, tp=tp)
    assert twin["weights"] == P.local_bytes(meta, model_lib.specs(cfg, tp),
                                            _StandIn((1, tp), ("data", "model")), rules)
    for r in ranks:
        assert int(r[f"{arch}/bytes/{stack}"]) == twin["weights"]
        assert int(r[f"{arch}/cache_bytes/{stack}"]) == twin["cache"]


@pytest.mark.parametrize("stack", list(R.STACKS))
@pytest.mark.parametrize("tp,arch", CASES)
def test_prefill_decode_collectives_equal_the_dry_run(runs, tp, arch, stack):
    """A prefill's (the encoder's included) and each decode step's
    collectives, by kind in count and raw bytes, are
    ``dryrun.call_collectives``' count on every rank."""
    _, ranks = runs(tp, arch)
    for r in ranks:
        calls = json.loads(str(r[f"{arch}/coll/{stack}"]))
        assert len(calls) == 1 + R.DECODE_STEPS
        for have, want in calls:
            assert have == want and dict(have)["all-reduce"][0] > 0


@pytest.mark.parametrize("stack", R.SERVED)
@pytest.mark.parametrize("arch", R.HYBRID_SERVED)
def test_serve_matches_reference(runs, arch, stack):
    """The teacher-forced engine serve (refills one slot at a time, as an
    SSM or hybrid config must): the reference's trace and tokens, logits
    within 1e-4 of the largest."""
    ref, ranks = runs(2, arch, "serve")
    want, key = ref[stack], f"{arch}/serve/{stack}"
    assert list(want["kinds"]) == list(ranks[0][f"{key}/kinds"])
    assert np.array_equal(want["tokens"], ranks[0][f"{key}/tokens"])
    err, pads = _close(want["logits"], ranks[0][f"{key}/logits"], _port_cfg(arch, 2).vocab_size)
    assert err < LOGIT_RTOL and pads, (err, pads)


@pytest.mark.parametrize("stack", R.SERVED)
@pytest.mark.parametrize("arch", R.HYBRID_SERVED)
def test_serve_collectives_equal_the_dry_run(runs, arch, stack):
    _, ranks = runs(2, arch, "serve")
    for r in ranks:
        have, want = json.loads(str(r[f"{arch}/serve/{stack}/collectives"]))
        assert have == want and dict(have)["all-reduce"][0] > 0


@pytest.mark.parametrize("name,arch", [("unreduced_x_proj", MAMBA), ("other_ranks_kv", VLM),
                                       ("causal_encoder", ENC_DEC)])
def test_planted_faults_fail_the_limit(runs, name, arch):
    """``x_proj``'s partials left unreduced (each rank's dt, B and C from its
    own channels), a rank's cross queries paired with the next rank's KV
    heads, and the encoder made causal each leave the reference's 1e-4."""
    ref, ranks = runs(2, arch)
    vocab = _port_cfg(arch, 2).vocab_size
    assert _close(ref["float"], ranks[0][f"{arch}/pd/float"], vocab)[0] < LOGIT_RTOL
    assert _close(ref["float"], ranks[0][f"{arch}/fault/{name}"], vocab)[0] > LOGIT_RTOL


class _RankMesh:
    """A stand-in ``DeviceMesh``: its axis names, shape and one rank's
    coordinates."""

    def __init__(self, shape, names, coords):
        self.mesh_dim_names, self.mesh, self._coords = names, np.empty(shape), coords

    def get_coordinate(self):
        return list(self._coords)


@pytest.mark.parametrize("mode", ["w8a8", "ffn=bsdp_fused,mixer=w8a16"])
@pytest.mark.parametrize("arch", R.HYBRID_ARCHS)
def test_sharded_draw_equals_slicing_the_whole_conversion(arch, mode):
    """``materialize_converted(..., mesh=)`` on every rank of tp = 2: each
    Mamba leaf (``in_proj`` block by block, ``x_proj`` and ``out_proj`` by
    their rows, the channel vectors), cross and encoder leaf equal, leaf
    for leaf and bit for bit, to the rank's shard of the whole tree's
    conversion."""
    from repro_torch.core import residency
    from repro_torch.serve import engine

    cfg, tp = _port_cfg(arch, 2), 2
    rules = _rules(P, cfg, tp)
    spec = model_lib.specs(cfg, tp)
    whole = engine.materialize_converted(cfg, mode, seed=4, device="cpu",
                                         min_dim=R.HYBRID_MIN_DIM, tp=tp)
    for rank in range(tp):
        mesh = _RankMesh((1, tp), ("data", "model"), (0, rank))
        got = engine.materialize_converted(cfg, mode, seed=4, device="cpu",
                                           min_dim=R.HYBRID_MIN_DIM, tp=tp, mesh=mesh,
                                           rules=rules)
        want = P.shard_tree(whole, spec, mesh, rules)
        pairs: list = []
        P.map_specs(got, spec, lambda leaf, s: pairs.append(leaf))
        wants: list = []
        P.map_specs(want, spec, lambda leaf, s: wants.append(leaf))
        assert len(pairs) == len(wants)
        for a, b in zip(pairs, wants):
            if isinstance(b, residency.QuantLinearState):
                assert (a.mode, a.k, a.n) == (b.mode, b.k, b.n)
                assert torch.equal(a.data, b.data) and torch.equal(a.scale, b.scale)
            else:
                assert torch.equal(a, b)


def test_falcon_mamba_at_tp3_raises():
    """d_inner 128 does not divide three ways: ``check_tp``, the engine and
    the dry run's collective count refuse it with a ``ValueError`` naming
    d_inner, as the reference cannot place it."""
    from repro_torch.serve import engine

    cfg = _port_cfg(MAMBA, 2)
    with pytest.raises(ValueError, match="d_inner 128"):
        model_lib.check_tp(cfg, TensorParallel(size=3, rank=0))
    with pytest.raises(ValueError, match="d_inner 128"):
        engine.ServeEngine({}, cfg, tp=3, mesh=_RankMesh((1, 3), ("data", "model"), (0, 0)),
                           device="cpu")
    with pytest.raises(ValueError, match="d_inner 128"):
        dryrun.call_collectives(cfg, "w8a8", "decode", batch=2, seq=1, tp=3)
    model_lib.check_tp(cfg, TensorParallel(size=2, rank=0))


@pytest.mark.parametrize("arch", R.HYBRID_ARCHS)
def test_training_mamba_and_cross_at_tp_still_raises(arch):
    """Mamba and cross layers (and the encoder) train at tp > 1
    (``tests/test_torch_tp_train.py`` holds them to the reference): the
    train path passes ``check_tp`` and the dry run counts its step; what
    still raises is what serving refuses, a ``d_inner`` the model axis does
    not divide."""
    cfg = _port_cfg(arch, 2)
    model_lib.check_tp(cfg, TensorParallel(size=2, rank=0))
    step = dryrun.train_step_collectives(cfg, mesh_axes={"data": 1, "model": 2}, rows=1, seq=4)
    assert sum(e.kind == "all-reduce" for e in step) > 2 * cfg.n_layers
    if cfg.d_inner % 3 and any(cfg.mixer_kind(i) == "mamba" for i in range(cfg.n_layers)):
        batch = {"tokens": torch.zeros((1, 4), dtype=torch.long)}
        with pytest.raises(ValueError, match="d_inner"):
            model_lib.forward({}, batch, cfg, tp=TensorParallel(size=3, rank=0))
        with pytest.raises(ValueError, match="d_inner"):
            dryrun.train_step_collectives(cfg, mesh_axes={"data": 1, "model": 3}, rows=1, seq=4)
