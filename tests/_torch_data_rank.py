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
prefilled whole on the rank, its cache cut to the rank's block of the ring
(``partitioning.shard_caches``) and :data:`DECODE_STEPS` ``decode_step``
calls over it.  It imports only ``repro_torch``, torch, numpy and
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
    for case, stack in SEQ_CASES:
        mode, cache = R.STACKS[stack]
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
            logits, caches = model_lib.prefill(eng.params, {"tokens": torch.from_numpy(
                prompt).long()}, eng.cfg, max_len=MAX_LEN, tp=eng._tp)
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
            rings = [c for c in caches if isinstance(c, dict) and "pos_ids" in c]
            out[f"{key}/masked"] = np.array([bool((c["pos_ids"] < 0).all()) for c in rings])
        if stack == "float" and case == "long":  # the cut: the rank's block of the ring
            ways, index = eng.view.block(("data",))
            ring = [c for c in whole if isinstance(c, dict) and "pos_ids" in c][0]
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
    main_part = main_serve if args["part"] == "serve" else main_seq
    out = main_part(rank, shape, workdir, mesh, args["arch"])
    np.savez(f"{workdir}/rank{rank}.npz", **out)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
