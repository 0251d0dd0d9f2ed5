"""Paged caches and ``prefix_cache`` over the engine's data axis, and the
sequence-parallel decode of MLA, cross and paged layers, against the
reference on the CPU.

The port's ranks are separate processes (``tests/_torch_data_rank.py``,
which imports only ``repro_torch``), two gloo ranks on ``localhost`` over a
``(data=2, model=1)`` mesh: one spawn a part (part, config), each its own
once-a-session computation (``_torch_once``).  Both packages run the port's
``materialize(cfg)`` weights in the reference's stacked layout, every leaf
that initialises to ones or zeros drawn off its init; the reference runs
here on an Auto-typed mesh of the same shape while the ranks run.

Held, the paged serves (``part`` ``"paged"``): :func:`_torch_data_rank.
prefix_schedule` (five greedy requests sharing a two-page prefix, a pool of
14 pages for 4 slots, a copy on write) on qwen3-1.7b's smoke config under
``prefix_cache`` on path B's weights (``w8a8``) over ``paged_bf16`` and on
path A's stack over ``paged_int4_bp_fused``, and minicpm3-4b's (MLA's latent
paged, ``k_rope`` a slot) on ``w8a8`` over ``paged_int8`` under ``fcfs``,
against the reference's ``ServeEngine`` under ``base_rules(data_axes=
("data",))`` with the same pool: the tokens equal the reference's and the
port's data = 1 run's, the logits within 1e-4 of the reference's largest
and 1e-5 of data = 1's (float32; a rank's batch is half the rows), the page
stats equal both key for key, and at each prefix attach and each request's
end every page a rank's table rows name equals data = 1's page at the ring
slots the row holds, and every page the prefix index holds equals it whole;
each rank's collectives (the model calls', the rounds' gathers, each prefix
registration's page copy, the closing token check) equal
``dryrun.serve_collectives``, its bytes (the whole pool, its rows of the
tables) ``dryrun.rank_bytes``.

Held, sequence-parallel decode (``part`` ``"seq"``) under ``plan(cfg,
SHAPES["long_500k"], mesh)`` rules: deepseek-v2-lite-16b and minicpm3-4b
(MLA's latent ring), seamless-m4t-medium (``attn_cross``) and
llama-3.2-vision-11b (``cross`` layers; both contexts whole on each rank)
on float weights and the ``bf16`` cache, and qwen3-1.7b on float weights
over ``paged_int4_bp_fused`` (a rank's block of the pool's pages): a
prompt of 40 tokens (the 32-slot ring wrapped) and one of 6 (rank 1's block
wholly masked), prefilled whole on each rank with its context, the cache
cut by ``partitioning.shard_caches``, three ``decode_step`` calls against
the reference's ``decode_step`` jitted under the same rules on caches
placed by its ``cache_pspecs``: within 1e-5 of the largest logit (float32),
every rank's logits equal, each call's collectives (one MAX and one SUM a
ring) equal to ``dryrun.call_collectives``, the rank's bytes to
``dryrun.rank_bytes``.
"""

import json
import os
import socket
import subprocess
import sys
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
from repro.launch.mesh import plan as ref_plan
from repro.models import model as ref_model
from repro.models.attention import attn_dims as ref_attn_dims
from repro.serve import engine as ref_engine
from repro.sharding import partitioning as RP
from repro_torch import configs, convert
from repro_torch.models import model as model_lib
from repro_torch.sharding import partitioning as P

SHAPE = (2, 1)
#: the parts, slowest first so that the workers start them first
PARTS = [("paged", "qwen3-1.7b"), ("seq", "seamless-m4t-medium"),
         ("seq", "llama-3.2-vision-11b"), ("seq", "deepseek-v2-lite-16b"),
         ("paged", "minicpm3-4b"), ("seq", "minicpm3-4b"), ("seq", "qwen3-1.7b")]
PAGED = [(arch, serve) for arch, serves in D.PAGED_SERVES.items() for serve in serves]
SEQ = [(arch, case, stack) for arch in D.LAYER_SEQ for case, stack in D.seq_cases(arch)]
JOIN_S = 400
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


def _mesh():
    return jax.make_mesh(SHAPE, ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:2])


def _numpy_params(arch) -> dict:
    """Seeded float weights of ``specs(cfg)`` in the reference's layout,
    every leaf that initialises to ones or zeros drawn off its init."""
    cfg = _port_cfg(arch)
    params = model_lib.materialize(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(1)

    def off_init(leaf, spec):
        if spec.init in ("ones", "zeros"):
            leaf = leaf + 0.3 * torch.randn(leaf.shape, generator=gen)
        return leaf

    return convert.params_to_numpy(P.map_specs(params, model_lib.specs(cfg), off_init), cfg)


def _ref_paged(arch, params, stack, cache, sched) -> dict:
    """The reference engine's serve of the prefix schedule on the mesh, its
    slots over ``data``, its pool of ``PAGE_POOL`` pages."""
    cfg = _ref_cfg(arch)
    mesh = _mesh()
    rules = RP.base_rules(data_axes=("data",), shard_kv_heads=ref_attn_dims(cfg, 1)[2])
    with jax.set_mesh(mesh):
        placed = jax.device_put(params, RP.shardings(ref_model.specs(cfg, 1), mesh, rules))
        eng = ref_engine.ServeEngine(placed, cfg, tp=1, rules=rules, slots=D.SLOTS,
                                     max_len=D.MAX_LEN, mode=R.STACKS[stack][0],
                                     cache_format=cache, scheduler=sched, min_dim=D.MIN_DIM,
                                     trace_logits=True, page_pool_pages=D.PAGE_POOL)
        reqs = D.prefix_schedule(eng, cfg.vocab_size)
    return {"tokens": np.array([t for r in reqs for t in r.out]),
            "logits": np.concatenate([np.reshape(np.asarray(lg), (-1, lg.shape[-1]))
                                      for _, _, lg in eng.logit_trace]),
            "kinds": np.array([f"{k}{list(s)}" for k, s, _ in eng.logit_trace]),
            "page_stats": eng.stats().pages}


def _ref_seq(arch, params, case, stack):
    """The reference's prefill of the case's prompt (with its context) and
    three decode steps jitted under ``plan``'s ``long_500k`` rules on caches
    placed by ``cache_pspecs`` → logits ``[4, 1, V]``."""
    cfg = _ref_cfg(arch)
    mode, cache = D.stack_of(stack)
    prompt, steps = D.seq_inputs(cfg.vocab_size, case)
    mesh = _mesh()
    rules = ref_plan(cfg, REF_SHAPES["long_500k"], mesh).rules
    run_cfg = cfg.scaled(cache_format=cache)
    with jax.set_mesh(mesh):
        p = jax.device_put(params, RP.shardings(ref_model.specs(cfg, 1), mesh, rules))
        if mode != "bf16":
            p = jax.jit(lambda w: ref_engine.convert_params(w, cfg, mode, min_dim=D.MIN_DIM))(p)
        batch = {"tokens": jnp.asarray(prompt)}
        batch.update({k: jnp.asarray(v) for k, v in D.seq_context(cfg).items()})
        logits, caches = jax.jit(lambda w, b: ref_model.prefill(
            w, b, run_cfg, tp=1, max_len=D.MAX_LEN, impl="jnp"))(p, batch)
        specs = RP.cache_pspecs(caches, rules, ref_attn_dims(cfg, 1)[2], run_cfg)
        caches = jax.device_put(caches, jax.tree.map(
            lambda s: NamedSharding(mesh, s), specs,
            is_leaf=lambda s: isinstance(s, PartitionSpec)))
        decode = jax.jit(lambda w, tok, c, q: ref_model.decode_step(
            w, tok, c, q, run_cfg, tp=1, rules=rules, impl="jnp"))
        rows = [np.asarray(logits[:, -1])]
        for i, tok in enumerate(steps):
            logits, caches = decode(p, jnp.asarray(tok[:, None]), caches,
                                    jnp.asarray([prompt.shape[1] + i], jnp.int32))
            rows.append(np.asarray(logits[:, -1]))
    return np.stack(rows)


@pytest.fixture(scope="module")
def runs(request, tmp_path_factory):
    """``runs(part, arch)`` → (reference, [rank results]) of one of
    :data:`PARTS` (:func:`_run_part`), computed once a session."""
    done: dict = {}

    def get(part, arch):
        if (part, arch) not in done:
            done[part, arch] = once_a_session(
                request, tmp_path_factory, f"test_torch_paged_data_{part}_{arch}",
                lambda: _run_part(tmp_path_factory, part, arch))
        return done[part, arch]

    return get


def _run_part(tmp_path_factory, part, arch):
    """Spawn the two ranks running ``part`` of ``arch``, compute the
    reference's meanwhile, then join the ranks within ``JOIN_S``."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(HERE.parent / "src")] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    work = tmp_path_factory.mktemp(f"paged_{part}_{arch}")
    tree = _numpy_params(arch)
    np.savez(work / f"{arch}.npz", **_flat(tree))
    params = jax.tree.map(jnp.asarray, tree)
    port = _free_port()
    procs = []
    for rank in range(2):
        arg = json.dumps({"rank": rank, "world": 2, "port": port, "workdir": str(work),
                          "shape": list(SHAPE), "arch": arch, "part": part})
        log = open(work / f"rank{rank}.log", "w")
        procs.append((subprocess.Popen([sys.executable, str(HERE / "_torch_data_rank.py"), arg],
                                       env=env, stdout=log, stderr=subprocess.STDOUT), log))
    t0 = time.monotonic()
    with ThreadPoolExecutor(2) as pool:
        if part == "paged":
            jobs = {serve: pool.submit(_ref_paged, arch, params, *serve)
                    for serve in D.PAGED_SERVES[arch]}
        else:
            jobs = {(case, stack): pool.submit(_ref_seq, arch, params, case, stack)
                    for case, stack in D.seq_cases(arch)}
        ref = {k: job.result() for k, job in jobs.items()}
    for proc, log in procs:
        try:
            proc.wait(timeout=max(1.0, JOIN_S - (time.monotonic() - t0)))
        except subprocess.TimeoutExpired:
            for p, _ in procs:
                p.kill()
        log.close()
    logs = [(work / f"rank{r}.log").read_text()[-3000:] for r in range(2)]
    assert all(p.returncode == 0 for p, _ in procs), "\n".join(logs)
    ranks = []
    for r in range(2):
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


def _key(serve) -> str:
    return "/".join(serve)


@pytest.mark.parametrize("arch,serve", PAGED)
def test_paged_serve_matches_reference_and_one_data_way(runs, arch, serve):
    """The tokens are the reference's and data = 1's, the logits within 1e-4
    of the reference's and 1e-5 of data = 1's, the page stats both's key for
    key."""
    ref, ranks = runs("paged", arch)
    want, key, vocab = ref[serve], _key(serve), _port_cfg(arch).vocab_size
    got = ranks[0]
    assert list(want["kinds"]) == list(got[f"{key}/kinds"])
    assert np.array_equal(want["tokens"], got[f"{key}/tokens"])
    assert np.array_equal(got[f"{key}/data1_tokens"], got[f"{key}/tokens"])
    err, pads = _close(want["logits"], got[f"{key}/logits"], vocab)
    assert err < SERVE_RTOL and pads, (err, pads)
    err, _ = _close(got[f"{key}/data1_logits"], got[f"{key}/logits"], vocab)
    assert err < SEQ_RTOL, err
    stats = json.loads(str(got[f"{key}/page_stats"]))
    assert stats == json.loads(str(got[f"{key}/data1_page_stats"]))
    assert set(stats) == set(want["page_stats"])
    assert all(stats[k] == pytest.approx(v) for k, v in want["page_stats"].items())
    if serve[2] == "prefix_cache":
        assert stats["prefix_hits"] > 0 and stats["cow_copies"] > 0


@pytest.mark.parametrize("arch,serve", PAGED)
def test_paged_pages_equal_one_data_way(runs, arch, serve):
    """At each prefix attach and each request's end, on every rank, every
    page the rank's table rows name (at the slots the rows hold) and every
    page the prefix index holds (whole) equal data = 1's."""
    _, ranks = runs("paged", arch)
    for r in ranks:
        events = r[f"{_key(serve)}/pages"]
        assert len(events) >= 5 and bool((events[:, 0] > 0).any())
        assert int(events[:, 1].sum()) == 0


@pytest.mark.parametrize("arch,serve", PAGED)
def test_paged_collectives_and_bytes_equal_the_dry_run(runs, arch, serve):
    """Each rank's collectives, each prefix registration's page copy among
    them, and its bytes: the whole pool and its slots' rows."""
    _, ranks = runs("paged", arch)
    for r in ranks:
        key = _key(serve)
        have, want = json.loads(str(r[f"{key}/collectives"]))
        assert have == want and dict(have)["all-gather"][0] > 0
        assert (len(r[f"{key}/shares"]) > 0) == (serve[2] == "prefix_cache")
        weights, cache, twin_weights, twin_cache = r[f"{key}/bytes"]
        assert weights == twin_weights and cache == twin_cache and cache > 0


@pytest.mark.parametrize("part,arch", PARTS)
def test_every_rank_computes_the_same(runs, part, arch):
    """Every result but each rank's own: the pages it compared, its model
    calls' collectives, and whether its block is masked."""
    _, ranks = runs(part, arch)
    own = ("/pages", "/collectives", "/masked", "/cut_pos")
    assert set(ranks[1]) == set(ranks[0])
    for key in ranks[0]:
        if not key.endswith(own):
            assert np.array_equal(ranks[0][key], ranks[1][key]), key


@pytest.mark.parametrize("arch,case,stack", SEQ)
def test_seq_decode_matches_reference(runs, arch, case, stack):
    ref, ranks = runs("seq", arch)
    err, pads = _close(ref[(case, stack)], ranks[0][f"{case}/{stack}/logits"],
                       _port_cfg(arch).vocab_size)
    assert err < SEQ_RTOL and pads, (err, pads)


@pytest.mark.parametrize("arch", list(D.LAYER_SEQ))
def test_seq_decode_collectives_and_bytes_equal_the_dry_run(runs, arch):
    """Each decode call's collectives (one MAX and one SUM a ring, none a
    cross-only layer) and the rank's bytes; the short prompt's blocks are
    wholly masked on rank 1 and live on rank 0."""
    _, ranks = runs("seq", arch)
    cfg = _port_cfg(arch)
    rings = sum(cfg.mixer_kind(i) in ("attn", "attn_cross") for i in range(cfg.n_layers))
    for r in ranks:
        for case, stack in D.seq_cases(arch):
            calls = json.loads(str(r[f"{case}/{stack}/collectives"]))
            assert len(calls) == D.DECODE_STEPS
            for have, want in calls:
                assert have == want and dict(have)["all-reduce"][0] == 2 * rings
            weights, cache, twin_weights, twin_cache = r[f"{case}/{stack}/bytes"]
            assert weights == twin_weights and cache == twin_cache
    stack = D.LAYER_SEQ[arch]
    assert bool(ranks[1][f"short/{stack}/masked"].all())
    assert not bool(ranks[0][f"short/{stack}/masked"].any())
