"""One rank of the port's data-axis CPU tests (``tests/test_torch_data_axis.py``).

Run as ``python tests/_torch_data_rank.py '<json>'`` with ``rank``,
``world``, ``port``, ``workdir``, ``shape`` (the ``(data, model)`` mesh),
``arch`` and ``part``: the rank joins a gloo process group on
``tcp://localhost:<port>``, builds the mesh, reads the float parameters in
the reference's stacked layout (``workdir/<arch>.npz``) and writes what it
computed to ``workdir/rank<r>.npz``.

``part`` ``"serve"``: the engine over the data axis (``ServeEngine(tp=,
mesh=)``, the slots split over ``data``) serves the teacher-forced schedule
under each of the config's :data:`SERVES` entries; ``"seq"``: the
sequence-parallel decode of ``plan``'s ``long_500k`` rules, a prompt
prefilled whole on the rank (with its context, for a cross config), its
cache cut to the rank's block of the ring (``partitioning.shard_caches``)
and :data:`DECODE_STEPS` ``decode_step`` calls over it; ``"paged"``: the
engine over the data axis on a paged cache format (:data:`PAGED_SERVES`),
:func:`prefix_schedule` served once at data = 1 and then over the mesh,
every page the rank's slots name held against data = 1's pool at each
prefix attach and each request's end (:func:`page_events`).  It imports only ``repro_torch``, torch, numpy and
``tests/_torch_tp_rank.py``'s shared pieces; the test module imports this
one for the shared inputs.
"""

from __future__ import annotations

import json
import sys

import numpy as np
import torch

import _torch_tp_rank as R

SLOTS = 4
MAX_LEN = 32
MIN_DIM = 16
#: a served config's stacks and schedulers (the teacher-forced schedule of
#: ``_torch_tp_rank.schedule``: three requests, so a refill group is split
#: 2 + 1 over two data ranks of 2 slots)
SERVES = {
    "qwen3-1.7b": (("w8a8", "fcfs"), ("A", "fcfs"), ("w8a8", "token_budget:budget=8")),
    "deepseek-v2-lite-16b": (("w8a8", "fcfs"),),
    "falcon-mamba-7b": (("w8a8", "fcfs"),),
}
#: the sequence-parallel cases: the prompt of 40 tokens wraps the 32-slot ring
#: (mixtral's smoke window, jamba's max_len); the prompt of 6 leaves every
#: position in rank 0's block, so that rank 1's block is wholly masked
PROMPTS = {"long": 40, "short": 6}
DECODE_STEPS = 3
#: the stacks each prompt is held on (the short one on the float stack)
SEQ_CASES = [("long", "float"), ("long", "w8a8"), ("long", "A"), ("short", "float")]
#: float weights over the fused int4 paged cache (a pool of 4 pages, 2 a rank)
PAGED_STACKS = {"fpaged": ("bf16", "paged_int4_bp_fused")}
#: the MLA, cross and paged sequence-parallel configs: both prompts on one stack
LAYER_SEQ = {"deepseek-v2-lite-16b": "float", "minicpm3-4b": "float",
             "seamless-m4t-medium": "float", "llama-3.2-vision-11b": "float",
             "qwen3-1.7b": "fpaged"}
#: the paged serves over the data axis: (stack, cache format, scheduler)
PAGED_SERVES = {
    "qwen3-1.7b": (("w8a8", "paged_bf16", "prefix_cache"),
                   ("A", "paged_int4_bp_fused", "prefix_cache")),
    "minicpm3-4b": (("w8a8", "paged_int8", "fcfs"),),
}
#: the paged serves' pool, short of slots × pages_per_slot (16), so that a
#: refill may wait for pages and the prefix index may be evicted
PAGE_POOL = 14


def seq_cases(arch: str) -> list:
    """``(prompt, stack)`` of ``arch``'s sequence-parallel cases."""
    if arch in LAYER_SEQ:
        return [("long", LAYER_SEQ[arch]), ("short", LAYER_SEQ[arch])]
    return SEQ_CASES


def stack_of(name: str) -> tuple:
    """``(mode, cache format)`` of a stack."""
    return PAGED_STACKS.get(name) or R.STACKS[name]


def seq_context(cfg) -> dict:
    """The prompt's seeded context ``[1, encoder_tokens, d_model]`` (a VLM's
    ``ctx_embeds``, an encoder-decoder's ``enc_embeds``), or none."""
    if not cfg.is_enc_dec and cfg.family != "vlm":
        return {}
    rng = np.random.default_rng(19)
    return {"enc_embeds" if cfg.is_enc_dec else "ctx_embeds":
            rng.normal(size=(1, cfg.encoder_tokens, cfg.d_model)).astype(np.float32)}


def prefix_schedule(eng, vocab: int):
    """Five requests sharing a 16-token prefix (two pages) with 2-9 own
    tokens and 3-16 greedy new tokens each (the first, whose pages the
    prefix index then holds, wraps its 32-slot ring into a shared page: a
    copy on write), run to the end."""
    rng = np.random.default_rng(23)
    shared = rng.integers(0, vocab, size=16).astype(np.int32)
    reqs = []
    for n, mn in zip((2, 7, 4, 9, 5), (16, 3, 6, 4, 5)):
        prompt = np.concatenate([shared, rng.integers(0, vocab, size=n).astype(np.int32)])
        reqs.append(eng.submit(prompt, mn))
    eng.run()
    return reqs


def _rings(caches) -> list:
    """Every attention ring of a cache (an ``attn_cross`` layer's self ring)."""
    rings = [c.get("self", c) for c in caches if isinstance(c, dict)]
    return [c for c in rings if "pos_ids" in c]


def page_events(eng, on_event) -> None:
    """``on_event(eng)`` after each prefix attach and before each request's
    end (its pages released) of ``eng``'s run."""
    attach, finish = eng._try_attach_prefix, eng._finish

    def attached(slot, req):
        ok = attach(slot, req)
        if ok:
            on_event(eng)
        return ok

    def finishing(req, slot, state):
        if slot is not None:
            on_event(eng)
        finish(req, slot, state)

    eng._try_attach_prefix, eng._finish = attached, finishing


def _pool_snapshot(eng) -> dict:
    """data = 1's pool leaves, slot rows and host tables at an event."""
    return {"caches": [{k: t.clone() for k, t in c.items()} for c in eng.caches],
            "tables": eng._tables.copy(), "valid": eng._table_valid.copy()}


def _held_pages(eng, snap, paging) -> tuple:
    """(pages compared, positions differing): every page a valid table row of
    the rank's slots names, at the ring slots the row holds (``pos_ids``
    >= 0; a page's other slots hold what the rank last wrote there, never
    read), with the row's positions, table and rope key; and every page the
    prefix index holds, whole — each against data = 1's ``snap``."""
    assert np.array_equal(eng._tables, snap["tables"])
    pages, differ = 0, 0
    page = eng._page
    for slot in range(eng._base, eng._base + eng._per):
        if not eng._table_valid[slot]:
            continue
        row = slot - eng._base
        for mine, want in zip(eng.caches, snap["caches"]):
            pos = mine["pos_ids"][row]
            differ += int((pos != want["pos_ids"][slot]).sum())
            live = pos >= 0
            for name, t in mine.items():
                if name in paging.TABLE_KEYS:
                    differ += int((t[row] != want[name][slot]).sum())
                elif name == "k_rope":
                    differ += int((t[row][live] != want[name][slot][live]).sum())
            for j, p in enumerate(eng._tables[slot]):
                held = live[j * page:(j + 1) * page]
                pages += 1
                for name, t in mine.items():
                    if name in paging.POOL_KEYS:
                        differ += int((t[p][held] != want[name][p][held]).sum())
    indexed = []
    stack = [eng.prefix_index.root]
    while stack:
        for node in stack.pop().values():
            indexed.append(node.page)
            stack.append(node.children)
    for p in indexed:
        pages += 1
        for mine, want in zip(eng.caches, snap["caches"]):
            for name, t in mine.items():
                if name in paging.POOL_KEYS:
                    differ += int((t[p] != want[name][p]).sum())
    return pages, differ


def cfg_for(arch: str, lib):
    """``arch``'s smoke config in float32 (``lib``: a configs module's
    ``get_smoke_config`` and its float32)."""
    get, f32 = lib
    return get(arch).scaled(dtype=f32)


def seq_inputs(vocab: int, case: str):
    """The prompt ``[1, P]`` and the decode steps' tokens ``[steps, 1]`` of a
    sequence-parallel case (seeded)."""
    rng = np.random.default_rng(17)
    prompt = rng.integers(0, vocab, size=(1, PROMPTS[case])).astype(np.int32)
    steps = rng.integers(0, vocab, size=(DECODE_STEPS, 1)).astype(np.int32)
    return prompt, steps


def _trace(eng) -> tuple:
    logits = np.concatenate([np.reshape(lg, (-1, lg.shape[-1])) for _, _, lg in eng.logit_trace])
    kinds = np.array([f"{k}{list(s)}" for k, s, _ in eng.logit_trace])
    return logits, kinds


def main_serve(rank, shape, workdir, mesh, arch) -> dict:
    from repro_torch import configs, convert
    from repro_torch.launch import dryrun
    from repro_torch.serve import engine

    cfg = cfg_for(arch, (configs.get_smoke_config, torch.float32))
    tp = shape[1]
    with np.load(f"{workdir}/{arch}.npz") as z:
        params = convert.params_from_numpy(R._nest({k: z[k] for k in z.files}), cfg, "cpu",
                                           tp=tp)
    out: dict = {}
    for stack, sched in SERVES[arch]:
        mode, cache = R.STACKS[stack]
        key = f"{stack}/{sched}"

        def build(m=mesh, t=tp):
            return engine.ServeEngine(params, cfg, tp=t, mesh=m, slots=SLOTS, max_len=MAX_LEN,
                                      mode=mode, cache_format=cache, scheduler=sched,
                                      min_dim=MIN_DIM, trace_logits=True, device="cpu")

        eng = build()
        assert eng.data_ways == shape[0] and eng._per == SLOTS // shape[0]
        with dryrun.ModelCallLog() as log:
            reqs = R.schedule(eng, cfg.vocab_size)
        out[f"{key}/collectives"] = np.array(json.dumps(dryrun.held_collectives(
            eng.view, dryrun.serve_collectives(eng, log.calls, rounds=log.rounds,
                                               min_dim=MIN_DIM))))
        out[f"{key}/tokens"] = np.array([t for r in reqs for t in r.out])
        out[f"{key}/logits"], out[f"{key}/kinds"] = _trace(eng)
        got = eng.resident_bytes()
        twin = dryrun.rank_bytes(eng.cfg, "decode", mesh_axes=dict(zip(("data", "model"), shape)),
                                 rules=eng.rules, qmode=mode, min_dim=MIN_DIM, batch=SLOTS,
                                 cache_len=MAX_LEN)
        out[f"{key}/bytes"] = np.array([got["weights"], got["cache"], twin["weights"],
                                        twin["cache"]])
        out[f"{key}/model_calls"] = np.array([len(log.calls), len(log.rounds)])
        if tp == 1 and sched == "fcfs":  # data = 1 on the same weights, in this process
            one = build(None, 1)
            R.schedule(one, cfg.vocab_size)
            out[f"{key}/data1_logits"] = _trace(one)[0]
    return out


def main_paged(rank, shape, workdir, mesh, arch) -> dict:
    from repro_torch import configs, convert
    from repro_torch.core import paging
    from repro_torch.launch import dryrun
    from repro_torch.serve import engine

    cfg = cfg_for(arch, (configs.get_smoke_config, torch.float32))
    with np.load(f"{workdir}/{arch}.npz") as z:
        params = convert.params_from_numpy(R._nest({k: z[k] for k in z.files}), cfg, "cpu")
    out: dict = {}
    for stack, cache, sched in PAGED_SERVES[arch]:
        mode = R.STACKS[stack][0]
        key = f"{stack}/{cache}/{sched}"

        def build(m):
            return engine.ServeEngine(params, cfg, mesh=m, slots=SLOTS, max_len=MAX_LEN,
                                      mode=mode, cache_format=cache, scheduler=sched,
                                      min_dim=MIN_DIM, trace_logits=True,
                                      page_pool_pages=PAGE_POOL, device="cpu")

        one, snaps = build(None), []
        page_events(one, lambda e: snaps.append(_pool_snapshot(e)))
        out[f"{key}/data1_tokens"] = np.array([t for r in prefix_schedule(one, cfg.vocab_size)
                                               for t in r.out])
        eng, held = build(mesh), []
        page_events(eng, lambda e: held.append(_held_pages(e, snaps[len(held)], paging)))
        with dryrun.ModelCallLog() as log:
            reqs = prefix_schedule(eng, cfg.vocab_size)
        assert eng.data_ways == shape[0] and len(held) == len(snaps)
        out[f"{key}/pages"] = np.array(held)
        out[f"{key}/collectives"] = np.array(json.dumps(dryrun.held_collectives(
            eng.view, dryrun.serve_collectives(eng, log.calls, rounds=log.rounds,
                                               shares=log.shares, min_dim=MIN_DIM))))
        out[f"{key}/shares"] = np.array(log.shares)
        out[f"{key}/tokens"] = np.array([t for r in reqs for t in r.out])
        out[f"{key}/logits"], out[f"{key}/kinds"] = _trace(eng)
        out[f"{key}/data1_logits"], data1_kinds = _trace(one)
        assert list(data1_kinds) == list(out[f"{key}/kinds"])
        out[f"{key}/page_stats"] = np.array(json.dumps(eng.stats().pages))
        out[f"{key}/data1_page_stats"] = np.array(json.dumps(one.stats().pages))
        got = eng.resident_bytes()
        twin = dryrun.rank_bytes(eng.cfg, "decode", mesh_axes=dict(zip(("data", "model"), shape)),
                                 rules=eng.rules, qmode=mode, min_dim=MIN_DIM, batch=SLOTS,
                                 cache_len=MAX_LEN, page_pool_pages=PAGE_POOL)
        out[f"{key}/bytes"] = np.array([got["weights"], got["cache"], twin["weights"],
                                        twin["cache"]])
    return out


def main_seq(rank, shape, workdir, mesh, arch) -> dict:
    from repro_torch import configs, convert
    from repro_torch.configs import SHAPES
    from repro_torch.core import kvcache, quant
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.models import attention
    from repro_torch.models import model as model_lib
    from repro_torch.serve import engine
    from repro_torch.sharding import partitioning as P

    cfg = cfg_for(arch, (configs.get_smoke_config, torch.float32))
    tp = shape[1]
    with np.load(f"{workdir}/{arch}.npz") as z:
        params = convert.params_from_numpy(R._nest({k: z[k] for k in z.files}), cfg, "cpu",
                                           tp=tp)
    rules = launch_mesh.plan(cfg, SHAPES["long_500k"], mesh).rules
    axes = dict(zip(("data", "model"), shape))
    out: dict = {}
    for case, stack in seq_cases(arch):
        mode, cache = stack_of(stack)
        # the engine holds the weights (the rank's model shards) and the view
        # of the mesh; it is never stepped
        eng = engine.ServeEngine(params, cfg, tp=tp, mesh=mesh, slots=shape[0], max_len=MAX_LEN,
                                 mode=mode, cache_format=cache, min_dim=MIN_DIM, device="cpu")
        coded = None
        if stack in R.CODED:
            ref = R._wait_codes(f"{workdir}/codes_{arch}_{stack}_{case}.npz")
            coded = (R.ExpertBoundaryCodes(ref, quant, cfg.n_experts, eng.view.coord("model"),
                                           tp) if cfg.n_experts
                     else R.BoundaryCodes(ref, quant, eng.view.coord("model"), tp))
        try:
            prompt, steps = seq_inputs(cfg.vocab_size, case)
            batch = {"tokens": torch.from_numpy(prompt).long()}
            batch.update({k: torch.from_numpy(v) for k, v in seq_context(cfg).items()})
            logits, caches = model_lib.prefill(eng.params, batch, eng.cfg, max_len=MAX_LEN,
                                               tp=eng._tp)
            rows = [logits[:, -1].numpy()]
            whole = caches
            caches = P.shard_caches(caches, mesh, rules, attention.attn_dims(cfg, tp)[2], eng.cfg)
            held = []
            for i, tok in enumerate(steps):
                eng.view.reset_counts()
                logits, caches = model_lib.decode_step(
                    eng.params, torch.from_numpy(tok[:, None]).long(), caches,
                    torch.tensor([prompt.shape[1] + i], dtype=torch.int32), eng.cfg,
                    tp=eng._tp, mesh=eng.view, rules=rules)
                rows.append(logits[:, -1].numpy())
                held.append(dryrun.held_collectives(eng.view, dryrun.call_collectives(
                    eng.cfg, mode, "decode", batch=1, seq=1, tp=tp, rules=rules,
                    min_dim=MIN_DIM, mesh_axes=axes)))
        finally:
            if coded is not None:
                coded.restore()
        key = f"{case}/{stack}"
        out[f"{key}/logits"] = np.stack(rows)
        out[f"{key}/collectives"] = np.array(json.dumps(held))
        twin = dryrun.rank_bytes(eng.cfg, "decode", mesh_axes=axes, rules=rules, qmode=mode,
                                 min_dim=MIN_DIM, batch=1, cache_len=MAX_LEN)
        out[f"{key}/bytes"] = np.array([eng.resident_bytes()["weights"],
                                        kvcache.cache_resident_bytes(caches), twin["weights"],
                                        twin["cache"]])
        if case == "short":  # rank 1's block of every ring holds no position
            seq = attention.seq_parallel(eng.view, rules)
            live = [(c["pos_ids"] >= 0) & attention._rank_pages(c, seq)[1]
                    if attention._paged_seq(kvcache.format_for(eng.cfg), seq)
                    else c["pos_ids"] >= 0 for c in _rings(caches)]
            out[f"{key}/masked"] = np.array([not bool(x.any()) for x in live])
        if stack == "float" and case == "long":  # the cut: the rank's block of the ring
            ways, index = eng.view.block(("data",))
            ring = _rings(whole)[0]
            ln = ring["pos_ids"].shape[1] // ways
            out[f"{key}/cut_pos"] = ring["pos_ids"][:, index * ln:(index + 1) * ln].numpy()
        if coded is not None:
            out[f"{key}/codes"] = np.array([coded.calls, len(coded.ref), coded.forced,
                                            coded.far])
    return out


def main(argv) -> int:
    args = json.loads(argv[1])
    rank, world, workdir = args["rank"], args["world"], args["workdir"]
    shape = tuple(args["shape"])
    torch.set_num_threads(1)
    from repro_torch.distributed import mesh as mesh_lib

    mesh_lib.init(rank=rank, world_size=world, init_method=f"tcp://localhost:{args['port']}",
                  device="cpu", backend="gloo")
    mesh = mesh_lib.device_mesh("cpu", shape, ("data", "model"))
    main_part = {"serve": main_serve, "seq": main_seq, "paged": main_paged}[args["part"]]
    out = main_part(rank, shape, workdir, mesh, args["arch"])
    np.savez(f"{workdir}/rank{rank}.npz", **out)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
