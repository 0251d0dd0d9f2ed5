"""Tensor-parallel serving of MLA and MoE layers against the reference on the CPU.

The smoke configs of deepseek-v2-lite-16b (MLA, a shared expert and 8
routed experts, layer 0 dense), mixtral-8x7b (GQA with a window, 4
experts) and minicpm3-4b (MLA with a low-rank query), in float32, as
``tests/_torch_tp_rank.py``'s ``moe_cfg`` sets them (capacity factor 1.25,
so that experts drop slots; deepseek 4 experts a token).  At tp = 2 the
experts divide the model axis and are sharded; at tp = 3 they do not: every
rank holds every expert and its third of their hidden width (``moe_mlp``,
48 wide), the heads pad 4 → 6 and the vocab 512 → 513.

The port's ranks are separate processes (``tests/_torch_tp_rank.py`` with
``"suite": "moe"``, which imports only ``repro_torch``), joined by a gloo
process group on ``localhost``: one spawn per world size, running all three
configs.  Both packages serve the same float weights (the port's
``materialize(cfg, tp=...)`` in the reference's stacked layout).  The
reference runs here on an Auto-typed ``(data=1, model=tp)`` mesh, under the
rules its ``plan`` gives (``shard_experts`` where the experts divide the
axis), its drives spread over a few threads while the ranks run.

Held: ``model.prefill`` and three ``decode_step`` calls on the float,
``w8a8`` and path A stacks within 1e-4 of the reference's largest logit,
every pad logit exactly ``NEG_INF`` (path A's int4 codes forced to the
reference's at rounding boundaries, the reference's per-expert roundings
stacked as the port's grouped ones); every rank's results equal; ``w8a8``
at tp = 2 equal to tp = 1 bit for bit; each rank's resident bytes equal to
the shards ``spec_for`` cuts; deepseek's teacher-forced ``w8a8`` serve
against the reference's.  Planted faults fail: the router's softmax over a
rank's own experts, the shared experts added on every rank, and the ranks'
per-token partial sums all-reduced in place of the per-slot outputs (no
longer bit for bit).  In process, no rank spawned: the per-slot outputs of
simulated ranks sum to the one-device MoE layer bit for bit, and a rank's
sharded draw and conversion equals its slice of the whole conversion.
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
from repro_torch.launch import dryrun
from repro_torch.models import model as model_lib
from repro_torch.sharding import partitioning as P

WORLDS = (2, 3)
ARCHS = R.MOE_ARCHS
MOE = tuple(a for a in ARCHS if a != "minicpm3-4b")
DEEPSEEK = ARCHS[0]
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
    return R.moe_cfg(arch, tp, (ref_smoke_config, jnp.float32))


def _port_cfg(arch, tp):
    return R.moe_cfg(arch, tp, (configs.get_smoke_config, torch.float32))


def _ref_rules(arch, tp):
    cfg = _ref_cfg(arch, tp)
    return RP.base_rules(data_axes=("data",), shard_kv_heads=ref_attn_dims(cfg, tp)[2],
                         shard_experts=not cfg.n_experts or cfg.n_experts % tp == 0)


def _mesh(tp):
    return jax.make_mesh((1, tp), ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:tp])


def _numpy_params(arch, tp) -> dict:
    """Seeded float weights of ``specs(cfg, tp)`` in the reference's layout."""
    cfg = _port_cfg(arch, tp)
    return convert.params_to_numpy(model_lib.materialize(cfg, seed=0, device="cpu", tp=tp), cfg)


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


def _ref_drive(arch, tp, params, stack, *, mesh=True, codes=None):
    """The reference's prefill and three decode steps → logits ``[4, 2, V]``
    (one jit for the prefill, one for the steps); on the mesh, or
    (``mesh=False``) on one device with the tp-shaped weights, its
    roundings appended to ``codes``."""
    cfg = _ref_cfg(arch, tp)
    mode, cache = R.STACKS[stack]
    rules = _ref_rules(arch, tp) if mesh else None
    toks, pos, steps, step_pos = R.prefill_inputs(cfg.vocab_size)

    def go(placed):
        if mode != "bf16":  # one compiled conversion: eager, the stacked experts' is slow
            placed = jax.jit(lambda p: ref_engine.convert_params(p, cfg, mode, min_dim=16))(placed)
        eng = ref_engine.ServeEngine(placed, cfg, tp=tp, rules=rules, slots=2, max_len=R.MAX_LEN,
                                     cache_format=cache, min_dim=16)
        prefill = jax.jit(lambda p, b: ref_model.prefill(
            p, b, eng.cfg, tp=tp, max_len=R.MAX_LEN, rules=rules, impl="jnp"))
        decode = jax.jit(lambda p, tok, c, q: ref_model.decode_step(
            p, tok, c, q, eng.cfg, tp=tp, rules=rules, impl="jnp"))
        _RECORD.codes = codes
        try:
            logits, caches = prefill(eng.params, {"tokens": jnp.asarray(toks),
                                                  "positions": jnp.asarray(pos)})
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
        return go(jax.device_put(params, RP.shardings(ref_model.specs(cfg, tp), _mesh(tp),
                                                      _ref_rules(arch, tp))))


def _ref_serve(arch, tp, params) -> dict:
    """The reference's teacher-forced ``w8a8`` serve on the mesh."""
    cfg = _ref_cfg(arch, tp)
    with jax.set_mesh(_mesh(tp)):
        placed = jax.device_put(params, RP.shardings(ref_model.specs(cfg, tp), _mesh(tp),
                                                     _ref_rules(arch, tp)))
        eng = ref_engine.ServeEngine(placed, cfg, tp=tp, rules=_ref_rules(arch, tp), slots=2,
                                     max_len=R.MAX_LEN, mode="w8a8", min_dim=16,
                                     trace_logits=True)
        reqs = R.schedule(eng, cfg.vocab_size)
    return {"tokens": np.array([t for r in reqs for t in r.out]),
            "logits": np.concatenate([np.reshape(np.asarray(lg), (-1, lg.shape[-1]))
                                      for _, _, lg in eng.logit_trace]),
            "kinds": np.array([f"{k}{list(s)}" for k, s, _ in eng.logit_trace])}


def _write_codes(work, arch, codes) -> None:
    np.savez(work / f"codes_{arch}.tmp.npz", **{f"{n}{i}": a for i, (v, q) in enumerate(codes)
                                                for n, a in (("v", v), ("q", q))})
    os.replace(work / f"codes_{arch}.tmp.npz", work / f"codes_{arch}.npz")


@pytest.fixture(scope="module")
def runs(request, tmp_path_factory):
    """Once a session (``_torch_once``): :func:`_runs`."""
    return once_a_session(request, tmp_path_factory, "test_torch_tp_moe",
                          lambda: _runs(tmp_path_factory))


def _runs(tmp_path_factory):
    """Spawn every world's ranks, compute the reference meanwhile (its
    boundary codes first: the ranks wait for them), then join each set
    within ``JOIN_S`` → ``{tp: (reference, [rank results])}``."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(HERE.parent / "src")] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    spawned, params = {}, {}
    for tp in WORLDS:
        work = tmp_path_factory.mktemp(f"tp{tp}")
        for arch in ARCHS:
            tree = _numpy_params(arch, tp)
            np.savez(work / f"{arch}.npz", **_flat(tree))
            params[tp, arch] = jax.tree.map(jnp.asarray, tree)
        port = _free_port()
        procs = []
        for rank in range(tp):
            arg = json.dumps({"rank": rank, "world": tp, "port": port, "workdir": str(work),
                              "suite": "moe"})
            log = open(work / f"rank{rank}.log", "w")
            procs.append((subprocess.Popen([sys.executable, str(HERE / "_torch_tp_rank.py"), arg],
                                           env=env, stdout=log, stderr=subprocess.STDOUT),
                          log))
        spawned[tp] = (work, procs, time.monotonic())

    def codes_job(tp, arch):
        codes: list = []
        _ref_drive(arch, tp, params[tp, arch], "A", mesh=False, codes=codes)
        _write_codes(spawned[tp][0], arch, codes)

    ref_quant.quantize = _recording_quantize
    try:
        with ThreadPoolExecutor(REF_THREADS) as pool:
            jobs = [pool.submit(codes_job, tp, arch) for tp in WORLDS for arch in ARCHS]
            drives = {(tp, arch, stack): pool.submit(_ref_drive, arch, tp, params[tp, arch], stack)
                      for tp in WORLDS for arch in ARCHS for stack in R.STACKS}
            serve = pool.submit(_ref_serve, DEEPSEEK, 2, params[2, DEEPSEEK])
            for job in jobs:
                job.result()
            ref = {key: job.result() for key, job in drives.items()}
            ref["serve"] = serve.result()
    finally:
        ref_quant.quantize = _QUANTIZE
    out = {}
    for tp in WORLDS:
        work, procs, t0 = spawned[tp]
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
        out[tp] = ref, ranks
    return out


def _close(want, got, vocab):
    """Max error over the real logits ÷ their largest magnitude, and whether
    every pad logit is exactly NEG_INF in both."""
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    err = np.abs(want[..., :vocab] - got[..., :vocab]).max() / np.abs(want[..., :vocab]).max()
    pads = bool((want[..., vocab:] == NEG_INF).all() and (got[..., vocab:] == NEG_INF).all())
    return err, pads


@pytest.mark.parametrize("stack", list(R.STACKS))
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("tp", WORLDS)
def test_prefill_decode_logits_match_reference(runs, tp, arch, stack):
    ref, ranks = runs[tp]
    cfg = _port_cfg(arch, tp)
    got = ranks[0][f"{arch}/pd/{stack}"]
    err, pads = _close(ref[tp, arch, stack], got, cfg.vocab_size)
    assert err < LOGIT_RTOL and pads, (err, pads)
    assert got.shape[-1] == model_lib.padded_vocab(cfg, tp)
    if stack == "A":  # every reference rounding met, none far from its boundary
        calls, ref_calls, _, far = ranks[0][f"{arch}/pd/A_codes"]
        assert calls == ref_calls and far == 0


@pytest.mark.parametrize("tp", WORLDS)
def test_every_rank_computes_the_same(runs, tp):
    _, ranks = runs[tp]
    for other in ranks[1:]:
        assert set(other) == set(ranks[0])
        for key in other:
            assert np.array_equal(ranks[0][key], other[key]), key


@pytest.mark.parametrize("arch", ARCHS)
def test_w8a8_tp2_is_bit_identical_to_one_device(runs, arch):
    """The router's logits gathered at the whole width, the experts' int32
    sums exact and the per-slot outputs summed over the ranks exactly, and
    the MLA ``wo``'s int32 partials: ``w8a8`` at tp = 2 is tp = 1's."""
    _, ranks = runs[2]
    assert np.array_equal(ranks[0][f"{arch}/pd/w8a8"], ranks[0][f"{arch}/pd/w8a8_tp1"])


@pytest.mark.parametrize("stack", list(R.STACKS))
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("tp", WORLDS)
def test_resident_bytes_equal_the_shard_twin(runs, tp, arch, stack):
    """Each rank's weight bytes equal the shards ``spec_for`` cuts of the
    converted tree on meta tensors: the stacked expert states cut along the
    expert axis at tp = 2, along their hidden width at tp = 3 (a bit-plane
    ``w_out`` whole), MLA's latent projections whole."""
    _, ranks = runs[tp]
    cfg = _port_cfg(arch, tp)
    meta = dryrun.serve_params_meta(cfg, R.STACKS[stack][0], min_dim=16, tp=tp)
    rules = P.base_rules(data_axes=("data",), shard_kv_heads=True,
                         shard_experts=not cfg.n_experts or cfg.n_experts % tp == 0)
    twin = dryrun.rank_bytes(cfg, "prefill", mesh_axes={"data": 1, "model": tp}, rules=rules,
                             qmode=R.STACKS[stack][0], min_dim=16)["weights"]
    assert twin < dryrun.analytic_weight_bytes(cfg, R.STACKS[stack][0], tp=tp, min_dim=16)
    assert twin == P.local_bytes(meta, model_lib.specs(cfg, tp),
                                 _StandIn((1, tp), ("data", "model")), rules)
    assert all(int(r[f"{arch}/bytes/{stack}"]) == twin for r in ranks)


@pytest.mark.parametrize("stack", [s for s in R.STACKS if s != "A"])
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("tp", WORLDS)
def test_prefill_decode_collectives_equal_the_dry_run(runs, tp, arch, stack):
    """MLA on a rank's heads, the experts sharded (tp = 2) or their hidden
    width (tp = 3), the shared experts: a prefill's and each decode step's
    collectives, by kind in count and raw bytes, are
    ``dryrun.call_collectives``' count on every rank."""
    _, ranks = runs[tp]
    for r in ranks:
        calls = json.loads(str(r[f"{arch}/coll/{stack}"]))
        assert len(calls) == 1 + R.DECODE_STEPS
        for have, want in calls:
            assert have == want and have


def test_deepseek_serve_collectives_equal_the_dry_run(runs):
    _, ranks = runs[2]
    for r in ranks:
        have, want = json.loads(str(r[f"{DEEPSEEK}/serve/collectives"]))
        assert have == want and dict(have)["all-reduce"][0] > 0


class _StandIn:
    def __init__(self, shape, names):
        self.axis_names, self.devices = names, np.empty(shape)


def test_deepseek_teacher_forced_serve_matches_reference(runs):
    ref, ranks = runs[2]
    want, got = ref["serve"], ranks[0]
    key = f"{DEEPSEEK}/serve"
    assert list(want["kinds"]) == list(got[f"{key}/kinds"])
    assert np.array_equal(want["tokens"], got[f"{key}/tokens"])
    err, pads = _close(want["logits"], got[f"{key}/logits"], _port_cfg(DEEPSEEK, 2).vocab_size)
    assert err < LOGIT_RTOL and pads, (err, pads)


@pytest.mark.parametrize("arch", MOE)
def test_planted_local_router_softmax_fails(runs, arch):
    """A softmax over the rank's own experts (its probabilities gathered
    after it) routes tokens elsewhere: the logits leave the 1e-4."""
    ref, ranks = runs[2]
    vocab = _port_cfg(arch, 2).vocab_size
    assert _close(ref[2, arch, "w8a8"], ranks[0][f"{arch}/pd/w8a8"], vocab)[0] < LOGIT_RTOL
    assert _close(ref[2, arch, "w8a8"], ranks[0][f"{arch}/fault/local_softmax"],
                  vocab)[0] > LOGIT_RTOL


def test_planted_shared_experts_on_every_rank_fail(runs):
    ref, ranks = runs[2]
    vocab = _port_cfg(DEEPSEEK, 2).vocab_size
    assert _close(ref[2, DEEPSEEK, "w8a8"], ranks[0][f"{DEEPSEEK}/fault/shared_every_rank"],
                  vocab)[0] > LOGIT_RTOL


def test_planted_per_token_partial_sums_are_not_bitwise(runs):
    """All-reducing each rank's per-token sums adds a token's 4 expert
    outputs in another order than one device: within 1e-4, but no longer
    tp = 1's bits.  (Two experts a token, as mixtral's, add to the same
    float in either order, so there this fault cannot show.)"""
    ref, ranks = runs[2]
    got = ranks[0][f"{DEEPSEEK}/fault/token_partials"]
    assert _close(ref[2, DEEPSEEK, "w8a8"], got, _port_cfg(DEEPSEEK, 2).vocab_size)[0] < LOGIT_RTOL
    assert not np.array_equal(got, ranks[0][f"{DEEPSEEK}/pd/w8a8_tp1"])


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_draw_serves_as_the_whole_tree(runs, arch):
    """An engine on the rank's shards drawn and converted alone
    (``materialize_converted(..., mesh=)``, ``sharded=True``) computes what
    the engine that cuts them from the whole tree computes, bit for bit."""
    _, ranks = runs[2]
    assert np.array_equal(ranks[0][f"{arch}/pd/w8a8_sharded_draw"], ranks[0][f"{arch}/pd/w8a8"])


#: the simulated ranks' capacity factor: 7 tokens a row, 4 of 8 experts
#: each, so an expert takes 2 slots of a row and drops the rest
CAPACITY = 0.5


@pytest.mark.parametrize("mode", ["bf16", "w8a8", "bsdp_fused"])
def test_simulated_ranks_slot_outputs_sum_to_one_device(mode):
    """Deepseek's MoE layer on one device against two simulated ranks: each
    rank's per-slot outputs (its 4 experts' slots, zero elsewhere) are
    disjoint, and their sum, combined and with the shared expert added,
    equals the one-device ``moe_apply`` bit for bit."""
    from repro_torch.core import residency
    from repro_torch.models import moe
    from repro_torch.serve import engine

    cfg = _port_cfg(DEEPSEEK, 2)
    params = engine.convert_params(model_lib.materialize(cfg, seed=2, device="cpu"), cfg, mode,
                                   min_dim=16)
    ffn = params["layers"][1]["ffn"]
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 7, cfg.d_model))
                         .astype(np.float32))
    want, _ = moe.moe_apply(ffn, x, cfg, capacity_factor=CAPACITY)
    idx, gate, _ = moe._route(ffn, x, cfg)
    cap = moe.capacity(cfg, x.shape[1], CAPACITY)
    routed = moe._dispatch(idx, gate, x.shape[1], cap, cfg.n_experts)
    assert not bool(routed[4].all())  # slots dropped: capacity binds

    def experts(w, r):
        if isinstance(w, residency.QuantLinearState):
            return residency.QuantLinearState(data=w.data[r * 4:(r + 1) * 4],
                                              scale=w.scale[r * 4:(r + 1) * 4], mode=w.mode,
                                              k=w.k, n=w.n)
        return w[r * 4:(r + 1) * 4]

    parts = [moe._slot_outputs(dict(ffn, w_in=experts(ffn["w_in"], r),
                                    w_out=experts(ffn["w_out"], r)),
                               x, cfg, routed, cap, first=4 * r) for r in range(2)]
    assert not bool(((parts[0] != 0) & (parts[1] != 0)).any())
    got = moe._combine(parts[0] + parts[1], routed[0], cfg.experts_per_tok)
    got = got + moe._shared(ffn, x, cfg)
    assert torch.equal(got, want)


class _RankMesh:
    """A stand-in ``DeviceMesh``: its axis names, shape and one rank's
    coordinates."""

    def __init__(self, shape, names, coords):
        self.mesh_dim_names, self.mesh, self._coords = names, np.empty(shape), coords

    def get_coordinate(self):
        return list(self._coords)


@pytest.mark.parametrize("mode", ["w8a8", "ffn=bsdp_fused,mixer=w8a16"])
@pytest.mark.parametrize("tp", WORLDS)
def test_sharded_draw_equals_slicing_the_whole_conversion(tp, mode):
    """``materialize_converted(..., mesh=)`` draws every leaf whole and keeps
    the rank's shard (a stacked expert leaf converts only the rank's
    experts): equal, leaf for leaf and bit for bit, to the rank's shards of
    the whole tree's conversion."""
    from repro_torch.core import residency
    from repro_torch.serve import engine

    cfg = _port_cfg(DEEPSEEK, tp)
    rules = P.base_rules(data_axes=("data",), shard_experts=cfg.n_experts % tp == 0)
    whole = engine.materialize_converted(cfg, mode, seed=4, device="cpu", min_dim=16, tp=tp)
    for rank in range(tp):
        mesh = _RankMesh((1, tp), ("data", "model"), (0, rank))
        got = engine.materialize_converted(cfg, mode, seed=4, device="cpu", min_dim=16, tp=tp,
                                           mesh=mesh, rules=rules)
        want = P.shard_tree(whole, model_lib.specs(cfg, tp), mesh, rules)
        pairs = []
        P.map_specs(got, model_lib.specs(cfg, tp), lambda leaf, spec: pairs.append(leaf))
        wants = []
        P.map_specs(want, model_lib.specs(cfg, tp), lambda leaf, spec: wants.append(leaf))
        assert len(pairs) == len(wants)
        for a, b in zip(pairs, wants):
            if isinstance(b, residency.QuantLinearState):
                assert (a.mode, a.k, a.n) == (b.mode, b.k, b.n)
                assert torch.equal(a.data, b.data) and torch.equal(a.scale, b.scale)
            else:
                assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_training_mla_and_moe_at_tp_still_raises(arch):
    """MLA and MoE layers train at tp > 1
    (``tests/test_torch_tp_train.py`` holds them to the reference): the train
    path passes ``check_tp`` and the dry run counts its step; what still
    raises is what serving refuses, the einsum MoE dispatch."""
    from repro_torch.distributed.mesh import TensorParallel

    cfg = _port_cfg(arch, 2)
    tp = TensorParallel(size=2, rank=0)
    model_lib.check_tp(cfg, tp)
    step = dryrun.train_step_collectives(cfg, mesh_axes={"data": 1, "model": 2}, rows=1, seq=4)
    assert sum(e.kind == "all-reduce" for e in step) > 3 * cfg.n_layers
    if cfg.n_experts:
        batch = {"tokens": torch.zeros((1, 4), dtype=torch.long)}
        with pytest.raises(NotImplementedError, match="einsum MoE dispatch"):
            model_lib.forward({}, batch, cfg.scaled(moe_impl="einsum"), tp=tp)


class _OneRank:
    """A model axis of one rank: every collective is the identity."""

    size, rank = 1, 0

    def all_reduce_sum(self, t):
        return t

    def all_reduce_max(self, t):
        return t


@pytest.mark.parametrize("mode", ["w8a8", "w8a16", "w4a8"])
def test_stacked_row_parallel_at_one_rank_is_the_stacked_apply(mode):
    """A stacked expert ``w_out`` through ``apply_stacked_row_parallel`` (the
    hidden-width branch's row-parallel product) on a model axis of one
    rank computes what ``apply_stacked`` does: bit for bit for the integer
    formats (their int32 sums, then the same epilogue), within float32
    rounding for ``w8a16``."""
    from repro_torch.core import residency

    rng = np.random.default_rng(6)
    w = torch.from_numpy(rng.normal(size=(3, 48, 40)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(3, 5, 48)).astype(np.float32))
    state = residency.from_float(w, mode)
    fmt = residency.get_format(mode)
    want = residency.apply_stacked(state, x)
    for impl in (None, "plain"):
        got = fmt.apply_stacked_row_parallel(state, x, _OneRank(), impl=impl)
        if mode == "w8a16":
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
        else:
            assert torch.equal(got, want), impl


@pytest.mark.parametrize("mode", ["w8a8", "bsdp_fused"])
def test_stacked_expert_states_shard_along_the_expert_axis(mode):
    """``shard_leaf`` and ``local_shape`` cut a stacked expert state by its
    expert axis where the experts divide the model axis (rank r holds
    experts ``[4r, 4r + 4)`` of 8 whole), and by the hidden width otherwise:
    at tp = 3 a row-parallel ``w8a8`` ``w_out`` keeps a third of its K rows
    (``k`` a third), a bit-plane one stays whole (K lives in its words)."""
    from repro_torch.core import residency

    for tp in (2, 3):
        cfg = _port_cfg(DEEPSEEK, tp)
        spec = model_lib.specs(cfg, tp)["layers"][1]["ffn"]["w_out"]
        w = torch.from_numpy(np.random.default_rng(7).normal(size=spec.shape).astype(np.float32))
        state = residency.from_float(w, mode)
        shard_experts = cfg.n_experts % tp == 0
        rules = P.base_rules(data_axes=("data",), shard_experts=shard_experts)
        sizes = {"data": 1, "model": tp}
        for rank in range(tp):
            got = P.shard_leaf(state, spec, sizes, {"data": 0, "model": rank}, rules)
            entries = P.leaf_entries(state, spec, rules)
            assert P.local_shape(state.data.shape, entries["data"], sizes) == tuple(got.data.shape)
            if shard_experts:
                held = slice(rank * 4, rank * 4 + 4)
                assert torch.equal(got.data, state.data[held])
                assert torch.equal(got.scale, state.scale[held])
                assert (got.k, got.n) == (state.k, state.n)
            elif mode == "w8a8":
                rows = slice(rank * 16, rank * 16 + 16)
                assert torch.equal(got.data, state.data[:, rows])
                assert torch.equal(got.scale, state.scale) and got.k == 16
            else:
                assert torch.equal(got.data, state.data) and got.k == state.k
