"""One rank of the port's tensor-parallel CPU tests (``tests/test_torch_tp.py``;
with ``"suite": "moe"``, ``tests/test_torch_tp_moe.py``; with ``"suite":
"hybrid"``, ``tests/test_torch_tp_hybrid.py``).

Run as ``python tests/_torch_tp_rank.py '<json>'`` with ``rank``, ``world``,
``port`` and ``workdir``: the rank joins a gloo process group on
``tcp://localhost:<port>``, builds a ``(data=1, model=world)`` mesh, reads
the float parameters in the reference's stacked layout (``workdir/
params.npz``, the reference's ``materialize(specs(cfg, world))``; for the
MoE and hybrid suites ``workdir/<arch>.npz``, one a config) and writes what it
computed to ``workdir/rank<r>.npz``.  It imports only ``repro_torch``,
torch and numpy; the test modules import this one for the shared inputs.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

ARCH = "qwen3-1.7b"
MAX_LEN = 32
#: the weight stacks held: float, path B's, path A's
STACKS = {"float": ("bf16", "bf16"), "w8a8": ("w8a8", "bf16"),
          "A": ("ffn=bsdp_fused,mixer=w8a16", "int4_bp_fused")}
SERVED = ("w8a8", "A")
#: the prefill rows (the second left-padded) and three decode steps
PROMPT_LENS = (6, 4)
DECODE_STEPS = 3
#: seconds a rank waits for the test process's reference codes
CODES_WAIT_S = 240


def smoke_cfg(tp: int, lib):
    """qwen3-1.7b's smoke config in float32 (``lib``: a configs module and
    its float32).  At tp = 3 the FFN is 96 wide, since the smoke config's
    128 (w_in's 256 columns) does not divide three ways in either package."""
    get, f32 = lib
    cfg = get(ARCH).scaled(dtype=f32)
    return cfg.scaled(d_ff=96) if tp == 3 else cfg


#: the MoE suite's configs: MLA + MoE with shared experts, a sliding window
#: + MoE, MLA with a low-rank query
MOE_ARCHS = ("deepseek-v2-lite-16b", "mixtral-8x7b", "minicpm3-4b")


def moe_cfg(arch: str, tp: int, lib):
    """``arch``'s smoke config in float32 for the MoE suite.  The MoE
    configs take capacity factor 1.25 (the smoke configs' 8.0 never drops)
    and deepseek 4 experts a token (its smoke config's 2 would make every
    combine a sum of two, which no order of adding changes).  At tp = 3
    the FFNs are 96 wide and the experts 48: the smoke widths (w_in's 256
    and 64 columns) do not divide three ways in either package."""
    get, f32 = lib
    cfg = get(arch).scaled(dtype=f32)
    if cfg.n_experts:
        cfg = cfg.scaled(capacity_factor=1.25)
    if arch == "deepseek-v2-lite-16b":
        cfg = cfg.scaled(experts_per_tok=4)
    if tp == 3:
        cfg = cfg.scaled(d_ff=96, **({"moe_d_ff": 48} if cfg.n_experts else {}))
    return cfg


def prefill_inputs(vocab: int):
    """``(tokens [2, S], positions [2, S])`` and the decode steps' tokens
    ``[steps, 2]`` and positions ``[steps, 2]`` (seeded)."""
    rng = np.random.default_rng(11)
    s = max(PROMPT_LENS)
    toks = np.zeros((len(PROMPT_LENS), s), np.int32)
    pos = np.zeros((len(PROMPT_LENS), s), np.int32)
    for i, n in enumerate(PROMPT_LENS):
        toks[i, s - n:] = rng.integers(0, vocab, size=n)
        pos[i] = np.arange(s) - (s - n)
    steps = rng.integers(0, vocab, size=(DECODE_STEPS, len(PROMPT_LENS))).astype(np.int32)
    step_pos = np.array(PROMPT_LENS, np.int32)[None] + np.arange(DECODE_STEPS,
                                                                  dtype=np.int32)[:, None]
    return toks, pos, steps, step_pos


def schedule(eng, vocab: int):
    """The teacher-forced schedule of tests/test_torch_serve.py: three
    requests (5, 3, 7 tokens; 6, 2, 4 new), forced tokens, run to the end."""
    rng = np.random.default_rng(0)
    reqs = [eng.submit(rng.integers(0, vocab, size=(n,)).astype(np.int32), mn,
                       force=rng.integers(0, vocab, size=(mn,)).astype(np.int32))
            for n, mn in zip((5, 3, 7), (6, 2, 4))]
    eng.run()
    return reqs


def transfer_array(world: int) -> np.ndarray:
    """The host array the transfer plans place: 6 rows a rank."""
    return np.arange(world * 6 * 5, dtype=np.float32).reshape(world * 6, 5)


def _nest(flat: dict) -> dict:
    out: dict = {}
    for key, a in flat.items():
        node = out
        *head, last = key.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = a
    return out


#: a rounding within this fraction of a step of the half-step between two
#: codes is a boundary (as tests/test_torch_cross.py's BoundaryCodes)
FLIP_TOL = 1e-3


class BoundaryCodes:
    """``quant.quantize`` with its codes forced to the reference's (``ref``:
    its roundings' values over scale and codes, in call order) where the
    two differ by one and both values lie within :data:`FLIP_TOL` of the
    half-step between them; ``forced`` counts those and ``far`` any other
    code that differs.  A row-parallel rounding (the port quantizes rank
    ``rank``'s ``K / tp`` features of each row, the reference the whole
    row) is compared with the rank's share of the reference's."""

    def __init__(self, ref, quant, rank: int = 0, tp: int = 1):
        self.ref, self.calls, self.forced, self.far = ref, 0, 0, 0
        self.rank, self.tp = rank, tp
        self._quant, self._quantize = quant, quant.quantize
        quant.quantize = self.quantize

    def _share(self, a, shape):
        """The rank's features of a whole-row reference rounding ``a`` for a
        port rounding of ``shape``; ``a`` itself where the sizes agree."""
        k = shape[-1]
        if self.tp == 1 or a.size != self.tp * int(np.prod(shape)):
            return a.reshape(-1)
        return a.reshape(-1, self.tp * k)[:, self.rank * k:(self.rank + 1) * k].reshape(-1)

    def restore(self):
        self._quant.quantize = self._quantize

    def _next_ref(self, shape):
        """The reference's next rounding (values over scale, codes) for a
        port rounding of ``shape``."""
        self.calls += 1
        return self.ref[self.calls - 1]

    def quantize(self, x, *, bits=8, axis=-1, scale=None):
        import dataclasses

        qt = self._quantize(x, bits=bits, axis=axis, scale=scale)
        shape = tuple(qt.data.shape)
        v_ref, q_ref = (self._share(a, shape) for a in self._next_ref(shape))
        q = qt.data.numpy().reshape(-1).copy()
        v = (x / qt.scale).numpy().reshape(-1)
        if q.shape != q_ref.shape:
            raise AssertionError(f"rounding {self.calls}: {q.shape} vs {q_ref.shape}")
        idx = np.flatnonzero(q != q_ref)
        mid = (q[idx].astype(np.float64) + q_ref[idx]) / 2
        near = ((np.abs(q[idx].astype(np.int32) - q_ref[idx]) == 1)
                & (np.abs(v[idx] - mid) <= FLIP_TOL) & (np.abs(v_ref[idx] - mid) <= FLIP_TOL))
        q[idx[near]] = q_ref[idx[near]]
        self.forced += int(near.sum())
        self.far += int((~near).sum())
        return dataclasses.replace(qt, data=torch.from_numpy(q.reshape(qt.data.shape)))


class ExpertBoundaryCodes(BoundaryCodes):
    """:class:`BoundaryCodes` where the port rounds a MoE layer's stacked
    expert input ``[e, M, K]`` at once and the reference (a ``vmap`` over the
    experts) rounds ``[M, K]`` once an expert: the reference's ``n_experts``
    roundings are stacked and the rank's ``e`` experts taken (all of them
    where ``e`` is ``n_experts``, the hidden width sharded)."""

    def __init__(self, ref, quant, n_experts: int, rank: int, tp: int = 1):
        super().__init__(ref, quant, rank, tp)
        self.n_experts = n_experts

    def _next_ref(self, shape):
        nxt = self.ref[self.calls][1] if self.calls < len(self.ref) else None
        if len(shape) != 3 or nxt is None or nxt.size != shape[1] * shape[2]:
            return super()._next_ref(shape)
        parts = self.ref[self.calls:self.calls + self.n_experts]
        self.calls += self.n_experts
        first = 0 if shape[0] == self.n_experts else self.rank * shape[0]
        return tuple(np.stack([a.reshape(shape[1:]) for a in arrays])[first:first + shape[0]]
                     for arrays in zip(*parts))


def _held_collectives(eng, calls, min_dim: int = 16) -> list:
    """The rank's recorded collectives beside the dry run's count of
    ``calls`` (``(kind, batch, seq)`` model calls), each as per-kind
    (count, raw bytes); the events are reset after."""
    from repro_torch.launch import dryrun

    held = dryrun.held_collectives(
        eng._tp, dryrun.serve_collectives(eng, calls, min_dim=min_dim, agree=False))
    eng._tp.reset_counts()
    return held


def _prefill_decode(eng, model_lib, vocab: int, context=None, min_dim: int = 16) -> dict:
    """The prefill and decode steps of :func:`prefill_inputs` (with the
    ``context`` arrays, :func:`hybrid_context`) → their last logits, the
    caches' bytes after the prefill and, at tp > 1, each call's recorded
    collectives beside the dry run's count (``collectives``, JSON)."""
    from repro_torch.core import kvcache

    toks, pos, steps, step_pos = prefill_inputs(vocab)
    held = []
    if eng._tp is not None:
        eng._tp.reset_counts()
    batch = {"tokens": torch.from_numpy(toks).long(), "positions": torch.from_numpy(pos),
             **{k: torch.from_numpy(a) for k, a in (context or {}).items()}}
    logits, caches = model_lib.prefill(eng.params, batch, eng.cfg, max_len=MAX_LEN,
                                       tp=eng._tp)
    cache_bytes = kvcache.cache_resident_bytes(caches)
    if eng._tp is not None:
        held.append(_held_collectives(eng, [("prefill",) + tuple(toks.shape)], min_dim))
    out = [logits[:, -1].numpy()]
    for tok, p in zip(steps, step_pos):
        logits, caches = model_lib.decode_step(eng.params, torch.from_numpy(tok[:, None]).long(),
                                               caches, torch.from_numpy(p), eng.cfg,
                                               tp=eng._tp)
        if eng._tp is not None:
            held.append(_held_collectives(eng, [("decode", len(tok), 1)], min_dim))
        out.append(logits[:, -1].numpy())
    return {"logits": np.stack(out), "collectives": np.array(json.dumps(held)),
            "cache_bytes": np.array(cache_bytes)}


def counted_serve(eng, run, min_dim: int = 16):
    """``run()`` (a serve of ``eng``) with its model calls recorded → (its
    result, [the rank's recorded collectives, the dry run's count of the
    calls and of the closing ``check_ranks_agree``] as JSON)."""
    from repro_torch.launch import dryrun

    eng._tp.reset_counts()
    with dryrun.ModelCallLog() as log:
        result = run()
    held = dryrun.held_collectives(eng._tp, dryrun.serve_collectives(eng, log.calls,
                                                                     min_dim=min_dim))
    return result, np.array(json.dumps(held))


def _bias_check(tp, layers) -> dict:
    """A row-parallel projection with a bias: added once after the
    all-reduce (``row_parallel(..., bias=)``), against the same bias put in
    every rank's partial (the input widened by a ones column, the weight by
    the bias row), the fault that adds it ``tp`` times."""
    rng = np.random.default_rng(5)
    k, n = 4 * tp.size, 6
    x = torch.from_numpy(rng.normal(size=(3, k)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(n,)).astype(np.float32))
    part = slice(tp.rank * 4, (tp.rank + 1) * 4)
    once = layers.row_parallel(w[part], x[:, part], tp, bias=b)
    ones = torch.ones((3, 1))
    every = layers.row_parallel(torch.cat([w[part], b[None]]), torch.cat([x[:, part], ones], 1),
                                tp)
    return {"want": (x @ w + b).numpy(), "once": once.numpy(), "every": every.numpy()}


def _wait_codes(path: str):
    """The reference's codes (values over scale and codes, in call order),
    written by the test process while the ranks run."""
    deadline = time.monotonic() + CODES_WAIT_S
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no reference codes after {CODES_WAIT_S} s")
        time.sleep(0.2)
    with np.load(path) as z:
        return [(z[f"v{i}"], z[f"q{i}"]) for i in range(len(z.files) // 2)]


def _moe_faults(moe):
    """The planted faults of the MoE suite, each a ``(name, function name,
    replacement(original))``: the router's softmax over the rank's own
    experts only (its probabilities gathered after it), the shared experts'
    whole output added on every rank and summed, and the ranks' per-token
    partial sums all-reduced in place of the per-slot outputs."""

    def local_softmax(orig):
        def logits(params, x, cfg, tp=None):
            local = torch.softmax(torch.einsum("bsd,de->bse", x.to(torch.float32),
                                               params["router"]), dim=-1)
            return torch.log(tp.all_gather(local, dim=-1))  # softmax(log p) = p / sum p
        return logits

    def shared_every_rank(orig):
        return lambda params, x, cfg, impl=None, tp=None: tp.all_reduce_sum(
            orig(params, x, cfg, impl=impl, tp=tp))

    def token_partials(orig):
        def combine(out_s, order, k, tp=None, sharded=False):
            y = orig(out_s, order, k)
            return tp.all_reduce_sum(y) if sharded else y
        return combine

    return (("local_softmax", "_router_logits", local_softmax),
            ("shared_every_rank", "_shared", shared_every_rank),
            ("token_partials", "_combine", token_partials))


def main_moe(rank: int, world: int, workdir: str, mesh) -> dict:
    """The MoE suite on one rank: every config of :data:`MOE_ARCHS` at tp =
    ``world``, prefill + decode on every stack (path A with the reference's
    boundary codes forced), the weights' resident bytes; at tp = 2 also
    the ``w8a8`` drive at tp = 1 on the same weights, deepseek's
    teacher-forced ``w8a8`` serve and the planted faults."""
    from repro_torch import configs, convert
    from repro_torch.core import quant
    from repro_torch.models import model as model_lib
    from repro_torch.models import moe
    from repro_torch.serve import engine

    out: dict = {}
    for arch in MOE_ARCHS:
        cfg = moe_cfg(arch, world, (configs.get_smoke_config, torch.float32))
        with np.load(f"{workdir}/{arch}.npz") as z:
            tree = _nest({k: z[k] for k in z.files})
        params = convert.params_from_numpy(tree, cfg, "cpu", tp=world)

        def build(stack, tp=world):
            mode, cache = STACKS[stack]
            return engine.ServeEngine(params, cfg, tp=tp, mesh=mesh if tp > 1 else None,
                                      slots=2, max_len=MAX_LEN, mode=mode, cache_format=cache,
                                      min_dim=16, trace_logits=True, device="cpu")

        def drive(stack, tp=world):
            return _prefill_decode(build(stack, tp), model_lib, cfg.vocab_size)["logits"]

        for stack in STACKS:
            eng = build(stack)
            out[f"{arch}/bytes/{stack}"] = np.array(eng.resident_bytes()["weights"])
            if stack != "A":
                pd = _prefill_decode(eng, model_lib, cfg.vocab_size)
                out[f"{arch}/pd/{stack}"] = pd["logits"]
                out[f"{arch}/coll/{stack}"] = pd["collectives"]
        if world == 2:
            out[f"{arch}/pd/w8a8_tp1"] = drive("w8a8", tp=1)
            # the rank's shards drawn and converted alone: the test's weights
            # are materialize(cfg, seed=0, tp=world)'s
            own = engine.materialize_converted(cfg, "w8a8", seed=0, device="cpu", min_dim=16,
                                               tp=world, mesh=mesh, rules=build("w8a8").rules)
            eng = engine.ServeEngine(own, cfg, tp=world, mesh=mesh, slots=2, max_len=MAX_LEN,
                                     mode="w8a8", min_dim=16, device="cpu", sharded=True)
            out[f"{arch}/pd/w8a8_sharded_draw"] = _prefill_decode(eng, model_lib,
                                                                  cfg.vocab_size)["logits"]
        if world == 2 and cfg.n_experts:
            for name, fn_name, plant in _moe_faults(moe):
                keep = getattr(moe, fn_name)
                setattr(moe, fn_name, plant(keep))
                try:
                    out[f"{arch}/fault/{name}"] = drive("w8a8")
                finally:
                    setattr(moe, fn_name, keep)
        if world == 2 and arch == MOE_ARCHS[0]:
            eng = build("w8a8")
            reqs, out[f"{arch}/serve/collectives"] = counted_serve(
                eng, lambda: schedule(eng, cfg.vocab_size))
            out[f"{arch}/serve/tokens"] = np.array([t for r in reqs for t in r.out])
            out[f"{arch}/serve/logits"] = np.concatenate(
                [np.reshape(lg, (-1, lg.shape[-1])) for _, _, lg in eng.logit_trace])
            out[f"{arch}/serve/kinds"] = np.array([f"{k}{list(s)}" for k, s, _ in
                                                   eng.logit_trace])
        eng = build("A")  # converted before the codes are forced
        codes = ExpertBoundaryCodes(_wait_codes(f"{workdir}/codes_{arch}.npz"), quant,
                                    cfg.n_experts, rank)
        try:
            out[f"{arch}/pd/A"] = _prefill_decode(eng, model_lib, cfg.vocab_size)["logits"]
        finally:
            codes.restore()
        out[f"{arch}/pd/A_codes"] = np.array([codes.calls, len(codes.ref), codes.forced,
                                              codes.far])
    return out


#: the hybrid suite's configs: Mamba-1, the Mamba / attention / MoE hybrid, the
#: VLM and the encoder-decoder; at tp = 3 the VLM alone (falcon-mamba's
#: d_inner of 128 does not divide three ways in either package)
HYBRID_ARCHS = ("falcon-mamba-7b", "jamba-1.5-large-398b", "llama-3.2-vision-11b",
                "seamless-m4t-medium")
HYBRID_WORLDS = {2: HYBRID_ARCHS, 3: ("llama-3.2-vision-11b",)}
#: the configs the engine serves (it serves no context)
HYBRID_SERVED = HYBRID_ARCHS[:2]
#: the hybrid suite's conversion threshold: ``x_proj`` (128 x 12 at the smoke
#: width) converts, so that its row-parallel integer path runs
HYBRID_MIN_DIM = 8
#: the stacks whose activation codes are forced to the reference's at
#: rounding boundaries (W8A8's int8 codes, path A's int4 ones)
CODED = ("w8a8", "A")


def hybrid_cfg(arch: str, tp: int, lib):
    """``arch``'s smoke config in float32 for the hybrid suite; at tp = 3 the
    FFN is 96 wide (w_in's 256 fused columns do not divide three ways)."""
    get, f32 = lib
    cfg = get(arch).scaled(dtype=f32)
    return cfg.scaled(d_ff=96) if tp == 3 else cfg


def hybrid_context(cfg) -> dict:
    """The prompt rows' seeded context: a VLM's ``ctx_embeds`` or an
    encoder-decoder's ``enc_embeds`` ``[2, encoder_tokens, d_model]``;
    empty for a config with no cross layer."""
    if not cfg.is_enc_dec and cfg.family != "vlm":
        return {}
    rng = np.random.default_rng(13)
    shape = (len(PROMPT_LENS), cfg.encoder_tokens, cfg.d_model)
    return {"enc_embeds" if cfg.is_enc_dec else "ctx_embeds":
            rng.normal(size=shape).astype(np.float32)}


def _hybrid_faults(cfg, mamba, attention, stack, layers):
    """The planted faults of the hybrid suite, each ``(name, arch, module,
    function name, replacement(original))``: falcon-mamba's ``x_proj``
    partials left unreduced (the rank's own dt, B and C), llama-vision's
    cross queries paired with the next rank's KV heads, seamless's encoder
    made causal."""

    def unreduced_x_proj(orig):
        def row_parallel(w, x, tp=None, impl=None, bias=None):
            if w.shape[-1] == cfg.dt_rank_actual + 2 * cfg.d_state:  # x_proj, not out_proj
                return layers.dense(w, x, impl=impl)
            return orig(w, x, tp, impl=impl, bias=bias)
        return row_parallel

    def other_ranks_kv(orig):
        def cross_kv(params, ctx, cfg, impl=None, tp=None):
            kv = orig(params, ctx, cfg, impl=impl, tp=tp)
            return {n: tp.all_gather_list(t)[(tp.rank + 1) % tp.size] for n, t in kv.items()}
        return cross_kv

    def causal_encoder(orig):
        def bidir(params, h, cfg, impl=None, tp=None):
            positions = attention._arange_positions(h)
            return attention._gqa(params, h, cfg, positions, impl=impl, tp=tp)[0]
        return bidir

    return (("unreduced_x_proj", HYBRID_ARCHS[0], mamba, "row_parallel", unreduced_x_proj),
            ("other_ranks_kv", HYBRID_ARCHS[2], attention, "cross_kv", other_ranks_kv),
            ("causal_encoder", HYBRID_ARCHS[3], stack, "_bidir_attn", causal_encoder))


def main_hybrid(rank: int, world: int, workdir: str, mesh, arch: str, part: str) -> dict:
    """One case of the hybrid suite on one rank: ``arch`` at tp = ``world``.
    ``part`` ``"pd"``: prefill + decode (with the context) on every stack,
    the ``w8a8`` and path A drives again with the reference's boundary codes
    forced, the weights' and the caches' resident bytes and each call's
    collectives, and at tp = 2 the ``w8a8`` drive at tp = 1 on the same
    weights and the planted faults; ``"serve"``: the teacher-forced engine
    serves (an SSM or hybrid config of :data:`HYBRID_SERVED`)."""
    from repro_torch import configs, convert
    from repro_torch.core import quant
    from repro_torch.models import attention, layers, mamba, stack
    from repro_torch.models import model as model_lib
    from repro_torch.serve import engine

    out: dict = {}
    cfg = hybrid_cfg(arch, world, (configs.get_smoke_config, torch.float32))
    with np.load(f"{workdir}/{arch}.npz") as z:
        tree = _nest({k: z[k] for k in z.files})
    params = convert.params_from_numpy(tree, cfg, "cpu", tp=world)
    context = hybrid_context(cfg)

    def build(stack_, tp=world):
        mode, cache = STACKS[stack_]
        return engine.ServeEngine(params, cfg, tp=tp, mesh=mesh if tp > 1 else None,
                                  slots=2, max_len=MAX_LEN, mode=mode, cache_format=cache,
                                  min_dim=HYBRID_MIN_DIM, trace_logits=True, device="cpu")

    def drive(stack_, tp=world, eng=None):
        return _prefill_decode(eng or build(stack_, tp), model_lib, cfg.vocab_size, context,
                               HYBRID_MIN_DIM)

    if part == "serve":
        for stack_ in SERVED:
            eng = build(stack_)
            reqs, out[f"{arch}/serve/{stack_}/collectives"] = counted_serve(
                eng, lambda: schedule(eng, cfg.vocab_size), HYBRID_MIN_DIM)
            out[f"{arch}/serve/{stack_}/tokens"] = np.array([t for r in reqs for t in r.out])
            out[f"{arch}/serve/{stack_}/logits"] = np.concatenate(
                [np.reshape(lg, (-1, lg.shape[-1])) for _, _, lg in eng.logit_trace])
            out[f"{arch}/serve/{stack_}/kinds"] = np.array(
                [f"{k}{list(s)}" for k, s, _ in eng.logit_trace])
        return out
    for stack_ in STACKS:
        eng = build(stack_)
        out[f"{arch}/bytes/{stack_}"] = np.array(eng.resident_bytes()["weights"])
        pd = drive(stack_, eng=eng)
        out[f"{arch}/pd/{stack_}"] = pd["logits"]
        out[f"{arch}/coll/{stack_}"] = pd["collectives"]
        out[f"{arch}/cache_bytes/{stack_}"] = pd["cache_bytes"]
    if world == 2:
        out[f"{arch}/pd/w8a8_tp1"] = drive("w8a8", tp=1)["logits"]
        for name, fault_arch, mod, fn_name, plant in _hybrid_faults(cfg, mamba, attention,
                                                                    stack, layers):
            if fault_arch != arch:
                continue
            keep = getattr(mod, fn_name)
            setattr(mod, fn_name, plant(keep))
            try:
                out[f"{arch}/fault/{name}"] = drive("float")["logits"]
            finally:
                setattr(mod, fn_name, keep)
    for stack_ in CODED:
        eng = build(stack_)  # converted before the codes are forced
        ref_codes = _wait_codes(f"{workdir}/codes_{arch}_{stack_}.npz")
        codes = (ExpertBoundaryCodes(ref_codes, quant, cfg.n_experts, rank, world)
                 if cfg.n_experts else BoundaryCodes(ref_codes, quant, rank, world))
        try:
            out[f"{arch}/pd/{stack_}_forced"] = drive(stack_, eng=eng)["logits"]
        finally:
            codes.restore()
        out[f"{arch}/pd/{stack_}_codes"] = np.array([codes.calls, len(codes.ref),
                                                     codes.forced, codes.far])
    return out


def main(argv) -> int:
    args = json.loads(argv[1])
    rank, world, workdir = args["rank"], args["world"], args["workdir"]
    torch.set_num_threads(1)
    from repro_torch import configs, convert
    from repro_torch.core import quant, residency, transfer
    from repro_torch.distributed import mesh as mesh_lib
    from repro_torch.models import layers
    from repro_torch.models import model as model_lib
    from repro_torch.serve import engine

    mesh_lib.init(rank=rank, world_size=world, init_method=f"tcp://localhost:{args['port']}",
                  device="cpu", backend="gloo")
    mesh = mesh_lib.device_mesh("cpu", (1, world), ("data", "model"))
    if args.get("suite") in ("moe", "hybrid"):
        out = (main_moe(rank, world, workdir, mesh) if args["suite"] == "moe"
               else main_hybrid(rank, world, workdir, mesh, args["arch"], args["part"]))
        np.savez(f"{workdir}/rank{rank}.npz", **out)
        torch.distributed.destroy_process_group()
        return 0
    cfg = smoke_cfg(world, (configs.get_smoke_config, torch.float32))
    with np.load(f"{workdir}/params.npz") as z:
        tree = _nest({k: z[k] for k in z.files})
    params = convert.params_from_numpy(tree, cfg, "cpu", tp=world)
    out: dict = {}

    def build(stack, tp=world):
        mode, cache = STACKS[stack]
        return engine.ServeEngine(params, cfg, tp=tp, mesh=mesh if tp > 1 else None,
                                  slots=2, max_len=MAX_LEN, mode=mode, cache_format=cache,
                                  min_dim=16, trace_logits=True, device="cpu")

    for stack in STACKS:
        pd = _prefill_decode(build(stack), model_lib, cfg.vocab_size)
        out[f"pd/{stack}"], out[f"coll/{stack}"] = pd["logits"], pd["collectives"]
    for stack in SERVED:
        eng = build(stack)
        reqs, out[f"serve/{stack}/collectives"] = counted_serve(
            eng, lambda: schedule(eng, cfg.vocab_size))
        out[f"serve/{stack}/tokens"] = np.array([t for r in reqs for t in r.out])
        out[f"serve/{stack}/logits"] = np.concatenate(
            [np.reshape(lg, (-1, lg.shape[-1])) for _, _, lg in eng.logit_trace])
        out[f"serve/{stack}/kinds"] = np.array([f"{k}{list(s)}" for k, s, _ in eng.logit_trace])
        out[f"serve/{stack}/bytes"] = np.array(eng.resident_bytes()["weights"])
        out[f"serve/{stack}/cache_bytes"] = np.array(eng.resident_bytes()["cache"])
    if world == 2 and rank == 0:  # the one-device serve of the same weights
        eng = build("w8a8", tp=1)
        schedule(eng, cfg.vocab_size)
        out["serve/w8a8/tp1_logits"] = np.concatenate(
            [np.reshape(lg, (-1, lg.shape[-1])) for _, _, lg in eng.logit_trace])
    tp = build("float")._tp
    for k, v in _bias_check(tp, layers).items():
        out[f"bias/{k}"] = v
    host = transfer_array(world)
    out["transfer/balanced"] = transfer.plan_balanced(host, mesh, ("model", None),
                                                      device="cpu").numpy()
    stats = transfer.measure(transfer.plan_balanced, host, mesh, ("model", None), device="cpu")
    out["transfer/balanced_bytes"] = np.array(stats.per_host_bytes[rank])
    out["transfer/naive"] = transfer.plan_naive(host, mesh, device="cpu").numpy()
    stats = transfer.measure(transfer.plan_naive, host, mesh, device="cpu")
    out["transfer/naive_bytes"] = np.array(stats.per_host_bytes[rank])

    # planted faults, each through the real code with one piece taken out
    keep_acts = residency.row_parallel_acts
    residency.row_parallel_acts = lambda x, tp, bits: quant.quantize_acts(x, bits=bits)
    out["fault/local_amax"] = _prefill_decode(build("w8a8"), model_lib,
                                              cfg.vocab_size)["logits"]
    residency.row_parallel_acts = keep_acts
    keep_mask = model_lib.mask_pad_vocab
    model_lib.mask_pad_vocab = lambda logits, cfg: logits
    out["fault/unmasked_pad"] = _prefill_decode(build("float"), model_lib,
                                                cfg.vocab_size)["logits"]
    model_lib.mask_pad_vocab = keep_mask
    # path A's int4 activation codes forced to the reference's at boundaries
    # (recorded by the test process while the ranks ran the rest)
    ref_codes = _wait_codes(f"{workdir}/codes_A.npz")
    eng = build("A")
    codes = BoundaryCodes(ref_codes, quant)
    out["pd/A_forced"] = _prefill_decode(eng, model_lib, cfg.vocab_size)["logits"]
    codes.restore()
    out["pd/A_codes"] = np.array([codes.calls, len(ref_codes), codes.forced, codes.far])
    np.savez(f"{workdir}/rank{rank}.npz", **out)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
