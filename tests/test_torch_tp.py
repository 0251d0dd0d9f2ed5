"""Tensor-parallel serving of the port against the reference on the CPU.

qwen3-1.7b's smoke config (float32) at tp = 2 and at tp = 3.  At tp = 3
the heads pad 4 → 6, the KV heads 2 → 3 and the vocab 512 → 513 (its pad
logit masked), and the FFN is 96 wide: the smoke config's 128 (w_in's 256
columns) does not divide three ways, in the reference's placement either.

The port's ranks are separate processes (``tests/_torch_tp_rank.py``,
which imports only ``repro_torch``), joined by a gloo process group on
``localhost``: one spawn per world size, all of its ranks at once, each
set with its own join timeout.  Their weights are the reference's
``materialize(specs(cfg, tp))`` written to a numpy file.  The reference
runs here on an Auto-typed ``(data=1, model=tp)`` mesh of the forced CPU
devices (jax 0.9's ``make_mesh`` defaults to Explicit axes, under which
the reference's sharded gathers and constraints raise), with its
parameters placed by ``P.shardings``.

Held: ``model.prefill`` and three ``decode_step`` calls on the float,
``w8a8`` and path A stacks within 1e-4 of the largest real logit, every
pad logit exactly ``NEG_INF``; the teacher-forced serves on ``w8a8`` and
path A with the reference's tokens and trace and logits within 1e-4;
every rank's results equal; ``w8a8`` at tp = 2 equal to tp = 1 bit for bit;
each rank's resident weight and cache bytes equal to the dry run's count
(``dryrun.rank_bytes``), and every prefill's, decode step's and serve's
collectives, by kind in count and raw bytes, to its count
(``dryrun.call_collectives``); the transfer plans' shards and byte counts.
Planted faults fail: a local activation amax, a bias added on every rank,
and an unmasked pad logit.  In process, no rank spawned: where the KV
heads stay whole (tp = 4), each rank's attention equals its head of the
one-device attention on every cache layout.
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

import _torch_tp_rank as R
from repro.configs import get_smoke_config as ref_smoke_config
from repro.core import quant as ref_quant
from repro.models import model as ref_model
from repro.models.attention import attn_dims as ref_attn_dims
from repro.serve import engine as ref_engine
from repro.sharding import partitioning as RP
from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.models import model as model_lib
from repro_torch.sharding import partitioning as P

WORLDS = (2, 3)
#: seconds a spawned set of ranks may take
JOIN_S = 300
LOGIT_RTOL = 1e-4
NEG_INF = float(np.float32(-1e30))  # as both packages store it in float32 logits
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


def _mesh(tp):
    return jax.make_mesh((1, tp), ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:tp])


def _ref_cfg(tp):
    return R.smoke_cfg(tp, (ref_smoke_config, jnp.float32))


def _port_cfg(tp):
    return R.smoke_cfg(tp, (configs.get_smoke_config, torch.float32))


def _ref_rules(tp):
    return RP.base_rules(data_axes=("data",), shard_kv_heads=ref_attn_dims(_ref_cfg(tp), tp)[2])


def _engine(tp, placed, stack, rules):
    mode, cache = R.STACKS[stack]
    return ref_engine.ServeEngine(placed, _ref_cfg(tp), tp=tp, rules=rules, slots=2,
                                  max_len=R.MAX_LEN, mode=mode, cache_format=cache,
                                  min_dim=16, trace_logits=True)


def _placed(tp, params):
    return jax.device_put(params, RP.shardings(ref_model.specs(_ref_cfg(tp), tp), _mesh(tp),
                                               _ref_rules(tp)))


def _ref_prefill_decode(tp, placed, stack, codes=None, rules="mesh", eng=None):
    """The reference's prefill and decode logits ``[steps + 1, 2, V]``; with
    ``codes`` (a list) every ``quant.quantize`` call appends its values over
    scale and its codes, in order (from inside the scanned layers, by an
    ordered ``jax.debug.callback``)."""
    cfg = _ref_cfg(tp)
    rules = _ref_rules(tp) if rules == "mesh" else rules
    toks, pos, steps, step_pos = R.prefill_inputs(cfg.vocab_size)
    eng = _engine(tp, placed, stack, rules) if eng is None else eng
    quantize = ref_quant.quantize

    def recorded(x, *, bits=8, axis=-1, scale=None):
        qt = quantize(x, bits=bits, axis=axis, scale=scale)
        jax.debug.callback(lambda v, q: codes.append((np.asarray(v), np.asarray(q))),
                           x / qt.scale, qt.data, ordered=True)
        return qt

    prefill = jax.jit(lambda params, batch: ref_model.prefill(
        params, batch, eng.cfg, tp=tp, max_len=R.MAX_LEN, rules=rules, impl="jnp"))
    decode = jax.jit(lambda params, tok, caches, p: ref_model.decode_step(
        params, tok, caches, p, eng.cfg, tp=tp, rules=rules, impl="jnp"))
    if codes is not None:
        ref_quant.quantize = recorded
    try:
        logits, caches = prefill(eng.params, {"tokens": jnp.asarray(toks),
                                              "positions": jnp.asarray(pos)})
        rows = [np.asarray(logits[:, -1])]
        for tok, p in zip(steps, step_pos):
            logits, caches = decode(eng.params, jnp.asarray(tok[:, None]), caches, jnp.asarray(p))
            rows.append(np.asarray(logits[:, -1]))
        jax.effects_barrier()
    finally:
        ref_quant.quantize = quantize
    return np.stack(rows)


def _reference(tp, params) -> dict:
    """The reference's prefill / decode logits and serves at ``tp``."""
    cfg, out = _ref_cfg(tp), {}
    with jax.set_mesh(_mesh(tp)):
        placed = _placed(tp, params)
        engines = {stack: _engine(tp, placed, stack, _ref_rules(tp)) for stack in R.STACKS}
        for stack in R.STACKS:
            out[f"pd/{stack}"] = _ref_prefill_decode(tp, placed, stack, eng=engines[stack])
        for stack in R.SERVED:
            eng = engines[stack]
            reqs = R.schedule(eng, cfg.vocab_size)
            out[f"serve/{stack}/tokens"] = np.array([t for r in reqs for t in r.out])
            out[f"serve/{stack}/logits"] = np.concatenate(
                [np.reshape(np.asarray(lg), (-1, lg.shape[-1])) for _, _, lg in eng.logit_trace])
            out[f"serve/{stack}/kinds"] = np.array([f"{k}{list(s)}" for k, s, _ in
                                                    eng.logit_trace])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Spawn every world's ranks, compute the reference meanwhile, then join
    each set within ``JOIN_S`` → ``{tp: (reference, [rank results])}``."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(HERE.parent / "src")] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    spawned, params = {}, {}
    for tp in WORLDS:
        work = tmp_path_factory.mktemp(f"tp{tp}")
        params[tp] = RP.materialize(ref_model.specs(_ref_cfg(tp), tp), jax.random.PRNGKey(0))
        np.savez(work / "params.npz", **_flat(params[tp]))
        port = _free_port()
        procs = []
        for rank in range(tp):
            arg = json.dumps({"rank": rank, "world": tp, "port": port, "workdir": str(work)})
            log = open(work / f"rank{rank}.log", "w")
            procs.append((subprocess.Popen([sys.executable, str(HERE / "_torch_tp_rank.py"), arg],
                                           env=env, stdout=log, stderr=subprocess.STDOUT),
                          log))
        spawned[tp] = (work, procs, time.monotonic())
    for tp in WORLDS:  # the ranks wait for these before their forced drive
        codes: list = []  # ordered callbacks need one device: no mesh, tp's shapes
        _ref_prefill_decode(tp, params[tp], "A", codes, rules=None)
        work = spawned[tp][0]
        np.savez(work / "codes_A.tmp.npz", **{f"{n}{i}": a for i, (v, q) in enumerate(codes)
                                               for n, a in (("v", v), ("q", q))})
        os.replace(work / "codes_A.tmp.npz", work / "codes_A.npz")
    out = {}
    for tp in WORLDS:
        ref = _reference(tp, params[tp])
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
@pytest.mark.parametrize("tp", WORLDS)
def test_prefill_decode_logits_match_reference(runs, tp, stack):
    """Path A's int4 activation codes are forced to the reference's where the
    two differ at a rounding boundary (``BoundaryCodes``: within 1e-3 of a
    step of the half-step; any other difference fails).  At tp = 3 one code
    at the left-padded row's last prompt position flips: unforced, that
    row's prefill logits differ by 1.4e-2 of the largest and every decode
    step's by under 3e-7."""
    ref, ranks = runs[tp]
    got = ranks[0]["pd/A_forced" if stack == "A" else f"pd/{stack}"]
    err, pads = _close(ref[f"pd/{stack}"], got, _port_cfg(tp).vocab_size)
    assert err < LOGIT_RTOL and pads, (err, pads)
    assert got.shape[-1] == model_lib.padded_vocab(_port_cfg(tp), tp)
    if stack == "A":
        calls, ref_calls, _, far = ranks[0]["pd/A_codes"]
        assert calls == ref_calls and far == 0


@pytest.mark.parametrize("stack", R.SERVED)
@pytest.mark.parametrize("tp", WORLDS)
def test_serve_matches_reference(runs, tp, stack):
    """Teacher-forced serve: the reference's trace and tokens, logits within
    1e-4 of the largest."""
    ref, ranks = runs[tp]
    key = f"serve/{stack}"
    assert list(ref[f"{key}/kinds"]) == list(ranks[0][f"{key}/kinds"])
    assert np.array_equal(ref[f"{key}/tokens"], ranks[0][f"{key}/tokens"])
    err, pads = _close(ref[f"{key}/logits"], ranks[0][f"{key}/logits"], _port_cfg(tp).vocab_size)
    assert err < LOGIT_RTOL and pads, (err, pads)


@pytest.mark.parametrize("tp", WORLDS)
def test_every_rank_computes_the_same(runs, tp):
    _, ranks = runs[tp]
    for other in ranks[1:]:
        for key in other:
            if not key.startswith("transfer/"):  # each rank's own shard
                assert np.array_equal(ranks[0][key], other[key]), key


def test_w8a8_tp2_is_bit_identical_to_one_device(runs):
    _, ranks = runs[2]
    assert np.array_equal(ranks[0]["serve/w8a8/logits"], ranks[0]["serve/w8a8/tp1_logits"])


def _rank_bytes(tp, stack):
    """The dry run's count of a rank's bytes (``dryrun.rank_bytes``) of a
    2-slot engine of the rank script's ring on ``stack``."""
    cfg = _port_cfg(tp)
    rules = P.base_rules(data_axes=("data",), shard_kv_heads=True)
    return dryrun.rank_bytes(cfg.scaled(cache_format=R.STACKS[stack][1]), "decode",
                             mesh_axes={"data": 1, "model": tp}, rules=rules,
                             qmode=R.STACKS[stack][0], min_dim=16, batch=2,
                             cache_len=R.MAX_LEN)


@pytest.mark.parametrize("stack", R.SERVED)
@pytest.mark.parametrize("tp", WORLDS)
def test_resident_bytes_equal_the_shard_twin(runs, tp, stack):
    """Each rank's weight bytes equal the dry run's count of a rank's
    (``rank_bytes``: the converted tree on meta tensors cut by the formats'
    ``data_axes``), and that count is the partitioning's ``local_bytes``."""
    _, ranks = runs[tp]
    cfg = _port_cfg(tp)
    twin = _rank_bytes(tp, stack)["weights"]
    meta = dryrun.serve_params_meta(cfg, R.STACKS[stack][0], min_dim=16, tp=tp)
    rules = P.base_rules(data_axes=("data",), shard_kv_heads=True)
    assert twin == P.local_bytes(meta, model_lib.specs(cfg, tp),
                                 _StandIn((1, tp), ("data", "model")), rules)
    assert all(int(r[f"serve/{stack}/bytes"]) == twin for r in ranks)


@pytest.mark.parametrize("stack", R.SERVED)
@pytest.mark.parametrize("tp", WORLDS)
def test_cache_bytes_equal_the_dry_run(runs, tp, stack):
    """Each rank's cache after the serve equals ``rank_bytes``' cache: the
    global cache on meta tensors cut by ``cache_pspecs``."""
    _, ranks = runs[tp]
    want = _rank_bytes(tp, stack)
    assert want["even"] and want["cache"] > 0
    assert all(int(r[f"serve/{stack}/cache_bytes"]) == want["cache"] for r in ranks)


def _held(record) -> list:
    """A rank's [recorded, counted] collectives, each a list of (kind,
    [count, raw bytes]), call by call."""
    return json.loads(str(record))


@pytest.mark.parametrize("stack", list(R.STACKS))
@pytest.mark.parametrize("tp", WORLDS)
def test_prefill_decode_collectives_equal_the_dry_run(runs, tp, stack):
    """A prefill's and each decode step's collectives on every rank, by
    kind in count and raw bytes, are ``dryrun.call_collectives``' count."""
    _, ranks = runs[tp]
    for r in ranks:
        calls = _held(r[f"coll/{stack}"])
        assert len(calls) == 1 + R.DECODE_STEPS
        for have, want in calls:
            assert have == want and {k for k, _ in have} == {"all-reduce", "all-gather"}


@pytest.mark.parametrize("stack", R.SERVED)
@pytest.mark.parametrize("tp", WORLDS)
def test_serve_collectives_equal_the_dry_run(runs, tp, stack):
    """A whole teacher-forced serve: the collectives of every model call the
    engine made and of its closing token check, as counted."""
    _, ranks = runs[tp]
    for r in ranks:
        have, want = _held(r[f"serve/{stack}/collectives"])
        assert have == want and dict(have)["all-reduce"][0] > 0


class _StandIn:
    def __init__(self, shape, names):
        self.axis_names, self.devices = names, np.empty(shape)


@pytest.mark.parametrize("tp", WORLDS)
def test_planted_local_amax_fails(runs, tp):
    """Quantizing the ``wo`` / ``w_out`` inputs with each rank's own amax
    gives other int8 codes: the logits leave the reference's 1e-4."""
    ref, ranks = runs[tp]
    vocab = _port_cfg(tp).vocab_size
    assert _close(ref["pd/w8a8"], ranks[0]["pd/w8a8"], vocab)[0] < LOGIT_RTOL
    assert _close(ref["pd/w8a8"], ranks[0]["fault/local_amax"], vocab)[0] > LOGIT_RTOL


@pytest.mark.parametrize("tp", WORLDS)
def test_planted_bias_on_every_rank_fails(runs, tp):
    _, ranks = runs[tp]
    want = ranks[0]["bias/want"]
    assert np.abs(ranks[0]["bias/once"] - want).max() < 1e-5
    assert np.abs(ranks[0]["bias/every"] - want).max() > 1e-2


def test_planted_unmasked_pad_logit_fails(runs):
    """At tp = 3 the pad logit (vocab 513) left unmasked is the reference's
    embedding row 512 against the final hidden state, not NEG_INF."""
    ref, ranks = runs[3]
    vocab = _port_cfg(3).vocab_size
    assert _close(ref["pd/float"], ranks[0]["pd/float"], vocab)[1]
    err, pads = _close(ref["pd/float"], ranks[0]["fault/unmasked_pad"], vocab)
    assert err < LOGIT_RTOL and not pads


@pytest.mark.parametrize("tp", WORLDS)
def test_transfer_plans(runs, tp):
    """``plan_balanced``: each rank holds exactly its rows and counts only
    their bytes; ``plan_naive``: every rank holds the whole array, copied
    from the host by rank 0 alone."""
    _, ranks = runs[tp]
    host = R.transfer_array(tp)
    for r, got in enumerate(ranks):
        mine = host[r * 6:(r + 1) * 6]
        assert np.array_equal(got["transfer/balanced"], mine)
        assert int(got["transfer/balanced_bytes"]) == mine.nbytes
        assert np.array_equal(got["transfer/naive"], host)
        assert int(got["transfer/naive_bytes"]) == (host.nbytes if r == 0 else 0)


@pytest.mark.parametrize("cache", ["bf16", "int4_bp_fused", "paged_int4_bp_fused"])
def test_whole_kv_heads_attend_as_one_device(cache, monkeypatch):
    """Where ``attn_dims`` keeps the KV heads whole (qwen3-1.7b's smoke
    config at tp = 4: 4 heads, 2 KV heads, ``shard_kv`` False), each rank's
    one query head reads its group's KV head from its whole cache: its
    prefill and decode attention equal that head of the one-device
    attention (``wo`` taken out), on every cache format's layout."""
    from repro_torch.distributed.mesh import TensorParallel
    from repro_torch.models import attention

    cfg = _port_cfg(2).scaled(cache_format=cache)
    assert attention.attn_dims(cfg, 4) == (4, 2, False)
    mixer = model_lib.materialize(cfg, seed=3, device="cpu", tp=4)["layers"][0]["mixer"]
    monkeypatch.setattr(attention, "row_parallel", lambda w, x, tp=None, impl=None: x)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(2, 6, cfg.d_model)).astype(np.float32))
    x1 = torch.from_numpy(rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32))
    pos = torch.tensor([[0, 1, 2, 3, 4, 5], [-2, -1, 0, 1, 2, 3]], dtype=torch.int32)
    step = torch.tensor([6, 4], dtype=torch.int32)
    want, cache_one = attention.gqa_prefill(mixer, x, cfg, cache_len=16, positions=pos)
    want_step, _ = attention.gqa_decode(mixer, x1, cache_one, cfg, pos=step)
    dh = cfg.d_head
    for rank in range(4):
        tp = TensorParallel(size=4, rank=rank, shard_kv=False)
        mine = dict(mixer, wq=mixer["wq"][:, rank * dh:(rank + 1) * dh])
        got, cache_rank = attention.gqa_prefill(mine, x, cfg, cache_len=16, positions=pos, tp=tp)
        got_step, _ = attention.gqa_decode(mine, x1, cache_rank, cfg, pos=step, tp=tp)
        head = slice(rank * dh, (rank + 1) * dh)
        torch.testing.assert_close(got, want[..., head], rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(got_step, want_step[..., head], rtol=1e-6, atol=1e-6)
