"""Serving engine: scheduler-driven continuous batching over resident weights.

Counterpart of :mod:`repro.serve.engine` with contiguous ring caches.
Weights are converted once (``convert_params``, or
``materialize_converted`` leaf by leaf as they are drawn) to the residency
policy ``mode`` and stay on the device; every prefill and decode step then runs
through each layer's format — the hand-written kernels on a CUDA device,
their plain versions on the CPU, or the plain PyTorch path everywhere with
``impl="plain"``.  Each ``step()`` is ``scheduler.plan(view)`` followed by
one microbatched prefill for all refills (left-padded, negative positions
masked) and one ``decode_step`` call for the chunk rows and decode rows
together (a chunking scheduler's later prompt chunks ride in the decode
call, right-aligned beside the one-token decode rows).

Requests walk ``QUEUED → PREFILLING → DECODING → DONE | CANCELLED``,
stream each token to ``on_token`` and carry three-clock stamps (wall
seconds, engine steps, processed positions) from which
:meth:`ServeEngine.stats` derives TTFT and TPOT.  Each step ends by
copying its logits to the host, so the wall clock covers the device work.

Attention (GQA, MLA or cross-attention) ignores pad tokens, so a config
whose every mixer is attention refills in one microbatch and may chunk its prompts; a Mamba
state would absorb pad tokens, so an SSM or hybrid config refills one
slot at a time and never chunks (the scheduler refills whole prompts), as
the reference does.  A MoE layer routes pad tokens like any other, and an
idle slot's Mamba state takes its pad token at every decode step until a
refill overwrites it, both as in the reference.

A ``paged_*`` cache format (:mod:`repro_torch.core.paging`) breaks the
slot → storage identity: the pool tensors hold ``page_pool_pages`` pages
(default ``slots × pages_per_slot``), each slot's block table names its
pages, a refill reserves a slot's pages before its prefill (waiting in the
queue while the pool is short), and under a scheduler that
``wants_prefix_cache`` (``prefix_cache``) a request attaches the pages of
the longest registered prefix of its prompt, refcounted, with a copy of a
shared page made on the device before any write into it.  Over a data
axis every rank holds the whole pool and its block's rows of the tables,
and writes only its own slots' rows into its copy; a page registered in
the prefix index is copied from its owner to every rank
(:meth:`ServeEngine._share_pages`), so that a slot of any rank may attach
it.

Each step is instrumented through :mod:`repro_torch.obs`: the spans
``engine.step`` / ``plan`` / ``reserve`` / ``prefill`` / ``cow`` /
``decode`` / ``complete``, the counters ``sched.admit``, ``sched.requeue``
and ``engine.tokens``, the ``request.*`` lifecycle events (carrying the
stamps :meth:`ServeEngine.stats` reads) and the ``bytes.weights`` /
``bytes.cache`` gauges.  ``ServeEngine(..., trace=True)`` keeps them in a
ring (:meth:`ServeEngine.timeline`); with no sink registered every site is
one boolean test.  The spans time the host; a span covers device work
only up to the logits' copy to the host inside it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import kvcache, paging, residency, transfer
from repro_torch.distributed.mesh import MeshView, TensorParallel
from repro_torch.models import attention
from repro_torch.models import model as model_lib
from repro_torch.sharding import partitioning as P
from repro_torch.obs import trace as obs
from repro_torch.serve import scheduler as sched_lib
from repro_torch.serve.scheduler import (
    CANCELLED,
    DECODING,
    DONE,
    PREFILLING,
    QUEUED,
    EngineStats,
    EngineView,
    Stamp,
    StepPlan,
)

#: parameter dict keys eligible for quantized residency (the reference's)
QUANTIZABLE_KEYS = (
    "wq", "wk", "wv", "wo",
    "w_in", "w_out", "w_uq", "w_dq", "w_dkv", "w_uk", "w_uv",
    "in_proj", "out_proj", "x_proj",
    "shared_w_in", "shared_w_out",
    "head",
)


def convert_params(params, cfg, spec, *, min_dim: int = 64):
    """One-time residency conversion (the amortized layout transform).

    ``spec`` is anything :meth:`ResidencySpec.parse` accepts.  The tree is
    walked with dot-joined paths (``layers.3.ffn.w_in``) and each leaf goes
    through :func:`leaf_converter`'s rule.
    """
    spec = residency.ResidencySpec.parse(spec)
    if spec.is_trivial:
        return params
    convert = leaf_converter(spec, min_dim)

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, path + (str(i),)) for i, v in enumerate(tree)]
        return convert(path, tree)

    return walk(params, ())


def materialize_converted(cfg, spec, *, seed: int = 0, device=None, min_dim: int = 64,
                          tp: int = 1, keep=None, mesh=None, rules=None):
    """``convert_params(materialize(cfg, seed, device, tp), cfg, spec)``,
    equal to it bit for bit, with each leaf converted as soon as it is
    drawn: the float tree is never held whole, so a model whose float
    weights do not fit the card beside their converted form (qwen1.5-32b)
    fits.  ``keep(leaf)`` maps each converted leaf before the next is drawn
    (``lambda leaf: tree_to(leaf, "cpu")`` keeps the tree on the host, where
    a tensor-parallel engine cuts each rank's shards from it).

    With ``mesh`` (this rank's ``DeviceMesh``, its ``model`` axis ``tp``
    ways) and ``rules``, each leaf is cut to the rank's shard as soon as it
    is drawn, equal bit for bit to the rank's shard of the whole tree's
    conversion (``ServeEngine(..., sharded=True)`` serves it): a stacked
    expert leaf whose expert axis the rules shard converts only the rank's
    experts (each expert converts on its own), a column-parallel weight
    (its output columns sharded, its K rows not: the Mamba ``in_proj``, a
    cross layer's projections, ``wq`` ...) only the rank's columns (each
    column converts on its own), any other leaf converts whole and is then
    cut (a weight's per-column scales are its whole column's, so a shard of
    its K rows cannot convert alone)."""
    convert = leaf_converter(residency.ResidencySpec.parse(spec), min_dim)
    if mesh is not None:
        convert = _shard_converter(convert, model_lib.specs(cfg, tp), mesh, rules)
    if keep is not None:
        return model_lib.draw(cfg, seed, device, tp=tp,
                              leaf=lambda path, w: keep(convert(path, w)))
    return model_lib.draw(cfg, seed, device, leaf=convert, tp=tp)


def _shard_converter(convert, spec_tree, mesh, rules):
    """``convert(path, w)`` followed by the cut to this rank's shard on
    ``mesh`` (:func:`materialize_converted`)."""
    sizes, coords = P.mesh_sizes(mesh), P.mesh_coords(mesh)

    def one(path, w):
        spec = spec_tree
        for key in path:
            spec = spec[int(key)] if isinstance(spec, list) else spec[key]
        entries = P.spec_for(spec.axes, rules)
        if w.ndim == 3 and entries[0] is not None:  # the rank's experts alone
            w = P.take_index(w, P.shard_index(w.shape, (entries[0], None, None), sizes, coords))
            spec = dataclasses.replace(spec, shape=tuple(w.shape), axes=(None,) + spec.axes[1:])
        elif w.ndim >= 2 and entries[-2] is None and entries[-1] is not None:
            # the rank's columns alone, converted as the whole leaf would be
            return convert(path, P.shard_leaf(w, spec, sizes, coords, rules), tuple(w.shape))
        return P.shard_leaf(convert(path, w), spec, sizes, coords, rules)

    return one


def leaf_converter(spec, min_dim: int):
    """The conversion rule of one leaf, ``convert(path, w)`` with ``path``
    the tuple of keys: a float tensor under a quantizable key whose last two
    axes are at least ``min_dim`` long becomes the :class:`QuantLinearState`
    of the format the policy selects for the dot-joined path (converted
    from float32, a block of columns at a time): a ``[K, N]`` weight one
    state, a stacked ``[E, K, N]`` expert weight one stacked state,
    converted an expert at a time.  Everything else stays as it is; a
    quantizable leaf of any other rank raises.  ``shape`` (default
    ``w.shape``) is the whole leaf's where ``w`` is a shard of it: the rule
    decides on the whole leaf."""

    def convert(path, w, shape=None):
        if not path or path[-1] not in QUANTIZABLE_KEYS:
            return w
        mode = spec.mode_for(".".join(path))
        if residency.get_format(mode).keeps_float_params or not isinstance(w, torch.Tensor):
            return w
        if w.ndim not in (2, 3):
            raise ValueError(f"{'.'.join(path)}: cannot convert a {w.ndim}-D weight "
                             f"{tuple(w.shape)} to {mode}")
        if min((shape or w.shape)[-2:]) < min_dim:
            return w
        return residency.from_float(w, mode, dtype=torch.float32)

    return convert


def tree_to(tree, device):
    """Every tensor and residency state of ``tree`` on ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    if isinstance(tree, (torch.Tensor, residency.QuantLinearState)):
        return tree.to(device)
    return tree


def resident_bytes(params) -> int:
    """Device-resident weight bytes (payload + scales for quantized leaves)."""
    if isinstance(params, dict):
        return sum(resident_bytes(v) for v in params.values())
    if isinstance(params, list):
        return sum(resident_bytes(v) for v in params)
    if isinstance(params, residency.QuantLinearState):
        return residency.resident_bytes(params)
    return params.numel() * params.element_size()


def _mesh_plan(cfg, tp: int, rules, mesh, *, slots: int):
    """(the rule table, the batch axes, their ways) of an engine at ``tp`` on
    ``mesh``; raises for what the engine cannot serve.  Without a mesh: one
    device (``tp`` must be 1).  On a mesh every axis is honoured: the model
    axis must be ``tp`` ways, and every other axis above one way must shard
    the slots (the rules' ``batch`` entry)."""
    if mesh is None:
        if tp > 1:
            raise ValueError("tp > 1 needs a mesh (a DeviceMesh with a 'model' axis)")
        return rules, (), 1
    model_lib.check_tp(cfg, TensorParallel(size=tp, rank=0))
    sizes = P.mesh_sizes(mesh)
    if sizes.get("model", 1) != tp:
        raise ValueError(f"tp={tp} but the mesh's model axis is {sizes.get('model')}")
    shard_kv = attention.attn_dims(cfg, tp)[2]
    shard_experts = bool(cfg.n_experts) and cfg.n_experts % tp == 0
    if rules is None:
        rules = P.base_rules(data_axes=tuple(a for a in ("pod", "data") if a in sizes)
                             or ("data",), shard_kv_heads=shard_kv,
                             shard_experts=shard_experts)
    want = {"heads": "model", "mlp": "model", "vocab": "model", "embed": None,
            "kv_heads": "model" if shard_kv else None, "kv_lora": None}
    if cfg.n_experts:  # the experts, or else their hidden width, on the model axis
        want.update(expert="model" if shard_experts else None,
                    moe_mlp=None if shard_experts else "model")
    if any(rules.get(k) != v for k, v in want.items()):
        raise ValueError(f"the tensor-parallel layers need the rules {want}, got "
                         f"{ {k: rules.get(k) for k in want} }")
    if rules.get("kv_seq") is not None:
        raise NotImplementedError(
            f"rules whose kv_seq is {rules['kv_seq']!r}: the engine places no cache by them (the "
            "reference engine keeps its caches whole under them); sequence-parallel decode is "
            "model.decode_step's on caches cut by partitioning.shard_caches (ROADMAP, Known "
            "differences)")
    batch = tuple(a for a in model_lib.batch_axes(rules) if sizes.get(a, 1) > 1)
    stray = [a for a, n in sizes.items() if n > 1 and a != "model" and a not in batch]
    if stray:
        raise ValueError(f"the mesh's axes {stray} shard nothing under the rules' batch entry "
                         f"{rules.get('batch')!r}: the engine would serve every slot on each "
                         "of their ranks")
    ways = 1
    for a in batch:
        ways *= sizes[a]
    if slots % ways:
        raise ValueError(f"{slots} slots do not divide the {ways} data ways of {batch} "
                         "(the engine cuts no uneven blocks of slots: ROADMAP, Known "
                         "differences)")
    return rules, batch, ways


@dataclasses.dataclass(eq=False)  # identity equality: queue membership
class Request:
    """One serving request as a lifecycle object (see module docstring).

    ``Request(uid, prompt, max_new)`` works positionally; ``uid=None`` is
    assigned at ``submit``.  ``force`` teacher-forces the emitted tokens;
    ``on_token(req, tok)`` streams every emitted token; ``prefilled``
    counts the prompt tokens consumed (the whole prompt once DECODING).
    """

    uid: Optional[int] = None
    prompt: np.ndarray = None  # [P] int32
    max_new: int = 0
    out: list = dataclasses.field(default_factory=list)
    force: Optional[np.ndarray] = None
    state: str = QUEUED
    prefilled: int = 0
    on_token: Optional[Callable[["Request", int], None]] = None
    arrival: Optional[Stamp] = None
    first_token: Optional[Stamp] = None
    finished: Optional[Stamp] = None

    @property
    def prompt_len(self) -> int:
        return len(self.prompt)

    @property
    def done(self) -> bool:
        """Terminal state (DONE or CANCELLED)."""
        return self.state in (DONE, CANCELLED)

    @done.setter
    def done(self, value: bool) -> None:  # legacy writers stop a request
        if value:
            self.state = DONE

    def cancel(self) -> None:
        """Cancel; the engine frees the slot at its next step (a queued
        request is dropped before it ever takes a slot)."""
        if self.state not in (DONE, CANCELLED):
            self.state = CANCELLED


class ServeEngine:
    """Greedy batched decoder over a fixed slot count (continuous batching).

    ``mode``: weight-residency policy (``"ffn=bsdp_fused,mixer=w8a16"``);
    ``cache_format``: decode-cache residency (``"int4_bp_fused"``);
    ``scheduler``: anything :func:`~repro_torch.serve.scheduler.make_scheduler`
    takes (``"fcfs"``, ``"sjf"``, ``"token_budget:budget=16"``, a class or
    an instance); ``impl="plain"`` serves through the plain PyTorch paths
    instead of the kernels; ``page_pool_pages`` caps the page pool of a
    ``paged_*`` cache (default ``slots × pages_per_slot``); ``trace=True``
    (or a sink) records the observability stream for :meth:`timeline`;
    ``clock`` stamps the wall-time clock; ``device`` defaults to
    ``"cuda"`` and raises when there is none.

    Tensor parallelism: ``tp > 1`` serves over the ``model`` axis of
    ``mesh`` (a ``DeviceMesh`` whose ``model`` axis is ``tp`` long; the
    PyTorch form of the reference's ambient mesh) under ``rules`` (default
    :func:`~repro_torch.sharding.partitioning.base_rules` over the mesh's
    ``pod`` / ``data`` axes, with the KV-head
    rule ``attn_dims`` gives, and ``expert`` on the model axis where the
    experts divide it, ``moe_mlp`` otherwise, as the reference's ``plan``
    decides).  ``params`` is then the global tree of
    ``model.specs(cfg, tp)`` (float or already converted), best on the
    host: it is converted as a whole, and each rank copies only its own
    shard of every leaf to ``device`` (:func:`repro_torch.core.transfer.
    place_shard`).  Every rank runs the same scheduler on the same
    all-gathered logits, and :meth:`run` ends by checking that every rank
    emitted the same tokens.  With ``sharded`` the ``params`` are this
    rank's shards, already converted to ``mode``
    (``materialize_converted(..., mesh=mesh, rules=rules)``), and are only
    moved to ``device``.

    The data axis: where the rules' ``batch`` entry names axes of the mesh
    (``pod`` × ``data``) above one way, at any ``tp``, each data rank holds
    the contiguous block of ``slots / ways`` slots that the reference's
    batch sharding gives it (its block's index pod-major), and its caches
    hold only those rows; the weights are whole on every data rank, as the
    rules place them without FSDP.  Every rank runs the same scheduler on
    the same view.  A refill group is split by owner: each rank prefills in
    one microbatch the refills of its own slots (left-padded to the group's
    longest prompt, as one device pads them), none if it owns none; a
    Mamba or hybrid config's refills are one request a call, run by the
    owner alone.  Chunk rows and decode rows run on the owning rank, every
    rank stepping its whole block.  After each prefill group and each
    decode call the greedy token ids of the rows computed are all-gathered
    over the batch axes in slot order (``MeshView.all_gather``), and their
    logits too under ``trace_logits``, so that every rank emits every
    slot's token; :meth:`run` ends by checking that every rank of the mesh
    emitted the same tokens.  A ``paged_*`` cache format's pool is whole on
    every data rank (the reference replicates it over ``data``) beside
    the rank's rows of the block tables; the pool, the prefix index and the
    table mirrors on the host are global, the same on every rank, and a
    rank writes its own slots' rows alone (prefills, appends, copies on
    write).  A page registered in the prefix index is copied from the
    registering slot's rank to every rank (:meth:`_share_pages`, one
    all-gather a registration), and copy-on-write precedes any later
    write into it, so every rank's copy of an indexed page is the same and
    a slot of any rank attaches it.  The engine raises where it cannot
    serve a mesh, and never ignores one: slots the data ways do not
    divide, rules whose ``kv_seq`` is set (the reference engine places no
    cache by them; sequence-parallel decode is ``model.decode_step``'s),
    and a mesh axis above one way that the rules do not name.
    """

    def __init__(self, params, cfg, *, tp: int = 1, rules=None, mesh=None,
                 slots: int = 4, max_len: int = 256,
                 impl: Optional[str] = None, mode: residency.SpecLike = "bf16",
                 cache_format: Optional[str] = None,
                 scheduler: sched_lib.SchedulerLike = "fcfs", min_dim: int = 64,
                 trace_logits: bool = False, trace=False,
                 page_pool_pages: Optional[int] = None,
                 clock: Callable[[], float] = time.perf_counter, device=None,
                 sharded: bool = False):
        self.device = resolve_device(device)
        spec = residency.ResidencySpec.parse(mode)
        self.tp, self.mesh = tp, mesh
        if cache_format is not None:
            cfg = dataclasses.replace(cfg, cache_format=cache_format)
        self._fmt = kvcache.format_for(cfg)
        self.scheduler = sched_lib.make_scheduler(scheduler)
        self.rules, self._batch_axes, self.data_ways = _mesh_plan(cfg, tp, rules, mesh,
                                                                  slots=slots)
        #: this rank's view of every mesh axis (None without a mesh), and of
        #: its model axis at tp > 1
        self.view = None if mesh is None else MeshView.from_mesh(
            mesh, shard_kv=attention.attn_dims(cfg, tp)[2])
        self._tp = self.view.axes["model"] if tp > 1 else None
        #: the rank's block of slots: [_base, _base + _per)
        self._per = slots // self.data_ways
        self._base = 0 if self.view is None else self.view.block(self._batch_axes)[1] * self._per
        if tp > 1:
            if sharded:  # the rank's shards, converted to ``mode`` already
                params = tree_to(params, self.device)
            else:
                if not spec.is_trivial:
                    params = convert_params(params, cfg, spec, min_dim=min_dim)
                params = P.shard_tree(
                    params, model_lib.specs(cfg, tp), mesh, self.rules,
                    place=lambda t, index: transfer.place_shard(t, index, self.device))
        else:
            params = tree_to(params, self.device)
            if not spec.is_trivial:
                params = convert_params(params, cfg, spec, min_dim=min_dim)
        self.params, self.cfg = params, cfg
        self.slots, self.max_len, self.impl = slots, max_len, impl
        self.mode = spec.describe()
        self.cache_format = self._fmt.name
        self.trace_logits = trace_logits
        #: when ``trace_logits``: [(kind, slots, np.ndarray logits)] in order;
        #: a chunked request's first-token logits also record as "prefill"
        self.logit_trace: list = []
        self.queue: list[Request] = []
        self.active: list[Optional[Request]] = [None] * slots
        self.requests: list[Request] = []
        self.caches = None
        self.pos = np.zeros(slots, np.int32)
        # left-padded microbatched refills and chunked prefill need layers
        # that ignore pad tokens: attention (self or cross) does, a Mamba
        # state does not
        self._pad_ok = all(cfg.mixer_kind(i) in ("attn", "attn_cross", "cross")
                           for i in range(cfg.n_layers))
        # -- paged residency: the pool, host mirrors of the block tables and
        # the prefix index
        self._paged = isinstance(self._fmt, paging.PagedCacheFormat)
        self.page_pool: Optional[paging.PagePool] = None
        self.prefix_index: Optional[paging.RadixPrefixIndex] = None
        if self._paged:
            self._page = self._fmt.page_size
            self._npp = self._fmt.pages_per_slot(max_len)
            self._ring_len = self._fmt.slot_capacity(max_len)
            pool_pages = slots * self._npp if page_pool_pages is None else int(page_pool_pages)
            self.page_pool = paging.PagePool(pool_pages, self._page)
            self.prefix_index = paging.RadixPrefixIndex(self._page)
            self._tables = np.zeros((slots, self._npp), np.int64)
            self._table_valid = np.zeros(slots, bool)
            # True: the page is held by the prefix index or another slot too,
            # so a write into it must copy it first
            self._shared_mask = np.zeros((slots, self._npp), bool)
        # prefix sharing remaps pool rows only, so every per-position leaf
        # must be paged: pure GQA self-attention (MLA keeps a float k_rope a
        # slot; cross and SSM layers keep per-slot state)
        self._prefix_sharing = (
            self._paged and self._pad_ok
            and bool(getattr(self.scheduler, "wants_prefix_cache", False))
            and all(cfg.mixer_kind(i) == "attn" for i in range(cfg.n_layers))
            and not getattr(cfg, "kv_lora_rank", 0))
        self._clock = clock
        self._next_uid = 0
        self._uids: set = set()
        self.step_index = 0
        self.work = 0
        self.wall_s = 0.0
        self._total_tokens = 0
        # trace=True registers a ring of this engine's stream; an outside
        # sink (the launcher's --trace) sees the same stream without it
        self._ring: Optional[obs.RingSink] = None
        if trace:
            self._ring = obs.register_sink(obs.RingSink() if trace is True else trace)
        self._weight_bytes: Optional[int] = None

    # -- admission ------------------------------------------------------
    def submit(self, prompt, max_new: int = 0, *, uid: Optional[int] = None,
               force=None, on_token: Optional[Callable] = None) -> Request:
        """Admit one request (a prompt, or a pre-built :class:`Request`).
        An omitted uid is assigned; a duplicate uid is rejected."""
        if isinstance(prompt, Request):
            req = prompt
        else:
            req = Request(uid=uid, prompt=np.asarray(prompt), max_new=max_new,
                          force=None if force is None else np.asarray(force),
                          on_token=on_token)
        if req.uid is None:
            while self._next_uid in self._uids:
                self._next_uid += 1
            req.uid = self._next_uid
        if req.uid in self._uids:
            raise ValueError(f"duplicate request uid {req.uid!r}")
        self.scheduler.admit(req, self._view())  # may raise: rejected
        self._uids.add(req.uid)
        self._next_uid = max(self._next_uid, req.uid) + 1
        req.state = QUEUED
        req.arrival = self._stamp()
        self.queue.append(req)
        self.requests.append(req)
        if obs.active():
            obs.counter("sched.admit", scheduler=self.scheduler.name)
            self._note_lifecycle("request.arrival", req, req.arrival)
        return req

    # -- bookkeeping ----------------------------------------------------
    def _stamp(self) -> Stamp:
        return Stamp(self._clock(), self.step_index, self.work)

    def _note_lifecycle(self, name: str, req: Request, stamp: Stamp) -> None:
        """One lifecycle event carrying the stamp the engine recorded, from
        which :func:`repro_torch.obs.metrics.request_stats_from_events`
        rebuilds the same TTFT/TPOT as :meth:`stats`."""
        obs.event(name, uid=req.uid, state=req.state, t=stamp.time, step=stamp.step,
                  work=stamp.work, prompt_len=req.prompt_len, new_tokens=len(req.out))

    def timeline(self) -> list:
        """The records this engine's ring kept (``trace=True``), in emission
        order: for :func:`~repro_torch.obs.export.chrome_trace`,
        :func:`~repro_torch.obs.metrics.summarize_spans` or
        :func:`~repro_torch.obs.metrics.dispatch_table`."""
        if self._ring is None:
            raise RuntimeError("timeline() requires ServeEngine(..., trace=True)")
        return self._ring.records()

    def _pool_stats(self) -> Optional[dict]:
        return None if self.page_pool is None else self.page_pool.stats()

    def _view(self) -> EngineView:
        return EngineView(slots=self.slots, active=tuple(self.active),
                          queue=tuple(self.queue), chunking_ok=self._pad_ok,
                          max_len=self.max_len, step_index=self.step_index,
                          pages=self._pool_stats())

    @staticmethod
    def _next_token(req: Request, greedy: int) -> int:
        i = len(req.out)
        if req.force is not None and i < len(req.force):
            return int(req.force[i])
        return greedy

    def _emit(self, req: Request, greedy: int) -> None:
        """Emit the request's next token: its forced one, else ``greedy``
        (the argmax of its logits row)."""
        tok = self._next_token(req, greedy)
        req.out.append(tok)
        self._total_tokens += 1
        if obs.active():
            obs.counter("engine.tokens")
        if req.first_token is None:
            req.first_token = self._stamp()
            if obs.active():
                self._note_lifecycle("request.first_token", req, req.first_token)
        if req.on_token is not None:
            req.on_token(req, tok)

    def _finish(self, req: Request, slot: Optional[int], state: str) -> None:
        req.state = state
        req.finished = self._stamp()
        if obs.active():
            self._note_lifecycle("request.finished", req, req.finished)
        if slot is not None:
            self.active[slot] = None
            if self._paged and self._table_valid[slot]:
                # drop this slot's references: pages the prefix index or
                # another slot holds stay resident
                self.page_pool.release(self._tables[slot])
                self._table_valid[slot] = False
                self._shared_mask[slot] = False
        self.scheduler.on_complete(req, self._view())

    def _sweep_terminal(self) -> None:
        """Free the queue entries and slots of requests moved to a terminal
        state from outside the engine (``cancel()``, ``done = True``)."""
        for req in list(self.queue):
            if req.state in (CANCELLED, DONE):
                self.queue.remove(req)
                self._finish(req, None, req.state)
        for slot in range(self.slots):
            req = self.active[slot]
            if req is not None and req.state in (CANCELLED, DONE):
                self._finish(req, slot, req.state)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _owns(self, slot: int) -> bool:
        return self._base <= slot < self._base + self._per

    def _gather_rows(self, own: dict) -> tuple:
        """``({slot: greedy id}, {slot: logits row})`` of every slot this
        round computed on any rank, from this rank's ``own`` rows (slot →
        logits row).  At one data way they are its own; over the data axis
        every rank's ids (``-1`` for a slot computed nowhere) are
        all-gathered over the batch axes in slot order, and under
        ``trace_logits`` the rows too (zeros where none was computed)."""
        if self.data_ways == 1:
            return {slot: int(np.argmax(row)) for slot, row in own.items()}, own
        ids = np.full(self._per, -1, np.int32)
        for slot, row in own.items():
            ids[slot - self._base] = np.argmax(row)
        every = self.view.all_gather(self._tensor(ids), self._batch_axes).cpu().numpy()
        greedy = {slot: int(i) for slot, i in enumerate(every) if i >= 0}
        rows = {}
        if self.trace_logits:
            block = np.zeros((self._per, model_lib.padded_vocab(self.cfg, self.tp)), np.float32)
            for slot, row in own.items():
                block[slot - self._base] = row
            every = self.view.all_gather(self._tensor(block), self._batch_axes).cpu().numpy()
            rows = {slot: every[slot] for slot in greedy}
        return greedy, rows

    # -- paged residency ------------------------------------------------
    def _alloc_pages(self, n: int) -> np.ndarray:
        """``n`` pages from the pool, evicting the least recently matched
        prefix-index leaves held by the index alone until it can give them."""
        while True:
            try:
                return self.page_pool.alloc(n)
            except paging.PoolExhausted:
                page = self.prefix_index.evict_lru(lambda p: self.page_pool.refs[p] == 1)
                if page is None:
                    raise
                self.page_pool.release([page])
                self.page_pool.note_eviction()

    def _try_attach_prefix(self, slot: int, req: Request) -> bool:
        """Map the request's leading block-table entries onto the pages of
        the longest registered prefix of its prompt (refcounted) and give it
        private pages for the rest.  It enters PREFILLING at the matched
        length, so the scheduler's chunks prefill only the rest; at least
        one prompt token is always left for the chunk that gives the first
        token's logits."""
        if not self._prefix_sharing or self.caches is None:
            return False
        matched = self.prefix_index.match(req.prompt)
        k = min(len(matched), (req.prompt_len - 1) // self._page, self._npp - 1)
        if k <= 0:
            return False
        shared = matched[:k]
        self.page_pool.retain(shared)
        try:
            private = self._alloc_pages(self._npp - k)
        except paging.PoolExhausted:
            self.page_pool.release(shared)
            raise
        self._tables[slot, :k] = shared
        self._tables[slot, k:] = private
        self._table_valid[slot] = True
        self._shared_mask[slot] = False
        self._shared_mask[slot, :k] = True
        n_tok = k * self._page
        if self._owns(slot):  # the slot's rows live on its own rank
            table_row = self._tensor(self._tables[slot].astype(np.int32))
            pos_row = np.full(self._ring_len, -1, np.int32)
            pos_row[:n_tok] = np.arange(n_tok, dtype=np.int32)
            pos_row = self._tensor(pos_row)
            for layer in self.caches:
                for name, t in layer.items():
                    if name in paging.TABLE_KEYS:
                        t[slot - self._base] = table_row
                    elif name == "pos_ids":
                        t[slot - self._base] = pos_row
        self.active[slot] = req
        self.pos[slot] = n_tok
        req.prefilled = n_tok
        req.state = PREFILLING
        self.page_pool.note_prefix_hit(n_tok)
        return True

    def _register_prefix(self, slot: int, req: Request) -> None:
        """Register a wholly prefilled prompt's page-aligned prefix in the
        radix index (at its PREFILLING → DECODING transition)."""
        if not self._prefix_sharing:
            return
        k = min(req.prompt_len // self._page, self._npp)
        if k <= 0:
            return
        new = self.prefix_index.insert(req.prompt[:k * self._page], self._tables[slot, :k])
        if new:
            self.page_pool.retain(new)
            if self.data_ways > 1:
                self._share_pages(new, slot)
        # the slot's prefix pages now held elsewhere too must be copied
        # before the ring wraps into them
        for j in range(k):
            if self.page_pool.refs[self._tables[slot, j]] > 1:
                self._shared_mask[slot, j] = True

    def _share_pages(self, pages: list, slot: int) -> None:
        """Over a data axis: make every rank's pool rows of ``pages`` (just
        registered in the prefix index by ``slot``'s request) those of the
        slot's rank, which wrote them.  Every rank registers the same pages
        in the same order, so every rank enters one all-gather over the
        batch axes of the pages' rows of every pool leaf of every layer,
        packed as bytes, and keeps the owner's block."""
        idx = self._tensor(np.asarray(pages, np.int64))
        leaves = [t for layer in self.caches for name, t in layer.items()
                  if name in paging.POOL_KEYS]
        rows = [t[idx] for t in leaves]
        packed = torch.cat([r.reshape(-1).view(torch.int8) for r in rows])
        every = self.view.all_gather(packed, self._batch_axes)
        if self._owns(slot):
            return
        owner = every[(slot // self._per) * packed.numel():][:packed.numel()]
        for t, r in zip(leaves, rows):
            n = r.numel() * r.element_size()
            t[idx] = owner[:n].clone().view(t.dtype).reshape(r.shape)
            owner = owner[n:]

    def _cow_writes(self, writes) -> None:
        """Copy-on-write before this step's appends: every shared page about
        to be written gets a private copy, made on the device.  ``writes``
        rows are ``(slot, positions)``; under ring recycling the first
        divergent write is the wrap into a shared page.  Over a data axis
        the host's tables change on every rank and a rank copies its own
        slots' pages alone."""
        if not self._shared_mask.any():
            return
        ops = []
        for slot, positions in writes:
            for p in positions:
                j = (int(p) % self._ring_len) // self._page
                if not self._shared_mask[slot, j]:
                    continue
                old = int(self._tables[slot, j])
                new = int(self._alloc_pages(1)[0])
                ops.append((slot, j, old, new))
                self._tables[slot, j] = new
                self._shared_mask[slot, j] = False
                self.page_pool.release([old])
                self.page_pool.note_cow()
        ops = [(slot - self._base, j, old, new) for slot, j, old, new in ops
               if self._owns(slot)]
        if not ops:
            return
        slots_t, js_t, old_t, new_t = (
            self._tensor(np.array(col, np.int64)) for col in zip(*ops))
        for layer in self.caches:
            for name, t in layer.items():
                if name in paging.POOL_KEYS:
                    t[new_t] = t[old_t]
                elif name in paging.TABLE_KEYS:
                    t[slots_t, js_t] = new_t.to(t.dtype)

    # -- execution ------------------------------------------------------
    def _prefill_slots(self, assignments: list) -> None:
        """ONE prefill call for every refill ``(slot, request, n_tokens)``
        (left-padded, pads at negative positions), then the per-row caches
        are spliced into the slots.  A whole prompt emits its first token;
        a first chunk (``n_tokens`` short of the prompt) leaves the request
        PREFILLING and its logits are discarded.  Over a data axis the call
        holds the refills of the rank's own slots alone (padded to the
        group's longest), and the first tokens are gathered
        (:meth:`_gather_rows`)."""
        s_max = max(n for _, _, n in assignments)
        self.work += len(assignments) * s_max
        mine = [a for a in assignments if self._owns(a[0])]
        if self.caches is None:
            self._init_caches()
        own = {}
        if mine:
            own = self._prefill_own(mine, s_max)
        greedy, rows = self._gather_rows(own)
        for slot, req, n in assignments:
            self.active[slot] = req
            self.pos[slot] = n
            req.prefilled = n
            if n == req.prompt_len:
                req.state = DECODING
                self._register_prefix(slot, req)
                if self.trace_logits:
                    self.logit_trace.append(("prefill", (slot,), rows[slot]))
                self._emit(req, greedy[slot])
            else:
                req.state = PREFILLING  # a chunk's logits are partial: discard

    def _init_caches(self) -> None:
        """The caches at first use, zeros: a paged pool leaf at the pool's
        pages (fewer than slots × pages_per_slot when page_pool_pages caps
        it; the whole pool on every data rank), every other leaf at the
        rank's rows."""
        def rows_of(name):
            return (self.page_pool.num_pages if self._paged and name in paging.POOL_KEYS
                    else self._per)

        self.caches = [{name: torch.zeros((rows_of(name), *t.shape[1:]), dtype=t.dtype,
                                          device=self.device)
                        for name, t in layer.items()}
                       for layer in model_lib.init_cache(self.cfg, self._per, self.max_len,
                                                         device="meta", tp=self.tp)]

    def _prefill_own(self, mine: list, s_max: int) -> dict:
        """The prefill call of this rank's refills ``mine``, left-padded to
        ``s_max``, its rows spliced into the caches → {slot: last logits}."""
        lens = [n for _, _, n in mine]
        toks = np.zeros((len(mine), s_max), np.int32)
        pos = np.zeros((len(mine), s_max), np.int32)
        for i, (_, req, n) in enumerate(mine):
            pad = s_max - n
            toks[i, pad:] = req.prompt[:n]
            pos[i] = np.arange(s_max, dtype=np.int32) - pad
        batch = {"tokens": self._tensor(toks).long()}
        if s_max != min(lens):
            batch["positions"] = self._tensor(pos)
        logits, cache_b = model_lib.prefill(self.params, batch, self.cfg,
                                            max_len=self.max_len, impl=self.impl, tp=self._tp)
        slot_ids = torch.tensor([slot - self._base for slot, _, _ in mine], dtype=torch.long,
                                device=self.device)
        if self._paged:
            # the prefill batch wrote through identity tables, so its pool
            # rows [i·npp, (i+1)·npp) are batch row i's pages in order: they
            # land on the pages _execute reserved for slot i
            new_tables = np.stack([self._tables[slot] for slot, _, _ in mine])
            page_ids = self._tensor(new_tables.reshape(-1))
            table_rows = self._tensor(new_tables.astype(np.int32))
        for full, rows in zip(self.caches, cache_b):
            for name, t in rows.items():
                if self._paged and name in paging.POOL_KEYS:
                    full[name][page_ids] = t
                elif self._paged and name in paging.TABLE_KEYS:
                    full[name][slot_ids] = table_rows
                else:
                    full[name][slot_ids] = t
        last_logits = logits[:, -1].cpu().numpy()
        return {slot: last_logits[i] for i, (slot, _, _) in enumerate(mine)}

    def _chunk_decode(self, chunks, decode_slots) -> list:
        """One ``decode_step`` for this step's chunk rows and decode rows.

        Rows are right-aligned in a ``[slots, S]`` token block (``S`` the
        longest chunk, 1 without chunks): a chunk row carries its next
        prompt tokens at positions ``prefilled..prefilled+n``, a decode row
        its last token at ``pos[slot]``, and the rest are pads at -1.  A
        chunk that ends its prompt emits the request's first token from its
        last logits.  Over a data axis the rank runs its block's rows and the
        greedy ids are gathered (:meth:`_gather_rows`).  Returns the
        ``(request, slot)`` pairs that finished.
        """
        s_len = max([n for _, n in chunks], default=1)
        toks = np.zeros((self.slots, s_len), np.int32)
        pos = np.full((self.slots, s_len), -1, np.int32)
        for slot, n in chunks:
            a = self.active[slot].prefilled
            toks[slot, s_len - n:] = self.active[slot].prompt[a:a + n]
            pos[slot, s_len - n:] = np.arange(a, a + n, dtype=np.int32)
        for slot in decode_slots:
            toks[slot, -1] = self.active[slot].out[-1]
            pos[slot, -1] = self.pos[slot]
        block = slice(self._base, self._base + self._per)
        logits, self.caches = model_lib.decode_step(
            self.params, self._tensor(toks[block]).long(), self.caches,
            self._tensor(pos[block]), self.cfg, impl=self.impl, tp=self._tp)
        self.work += toks.size
        step_logits = logits[:, -1].cpu().numpy()
        greedy, rows = self._gather_rows({self._base + i: row
                                          for i, row in enumerate(step_logits)})
        for slot, n in chunks:
            req = self.active[slot]
            req.prefilled += n
            self.pos[slot] = req.prefilled
            if req.prefilled >= req.prompt_len:
                req.state = DECODING  # the last chunk's logits are the first token's
                self._register_prefix(slot, req)
                if self.trace_logits:
                    self.logit_trace.append(("prefill", (slot,), rows[slot]))
                self._emit(req, greedy[slot])
        if decode_slots and self.trace_logits:
            self.logit_trace.append(
                ("decode", tuple(decode_slots), np.stack([rows[s] for s in decode_slots])))
        finished = []
        for slot in decode_slots:
            req = self.active[slot]
            self._emit(req, greedy[slot])
            self.pos[slot] += 1
            if len(req.out) >= req.max_new:
                finished.append((req, slot))
        return finished

    def _execute(self, plan: StepPlan) -> bool:
        """Run one validated :class:`StepPlan`; returns progress."""
        refills = []
        attached = 0
        starved = False
        with obs.span("engine.reserve", refills=len(plan.refills)):
            for slot, req, n in plan.refills:
                if self.active[slot] is not None:
                    raise ValueError(f"plan refills occupied slot {slot}")
                if req not in self.queue:
                    raise ValueError(f"plan refills unqueued request {req.uid}")
                self.queue.remove(req)
                try:
                    if self._try_attach_prefix(slot, req):
                        attached += 1  # the prefix is mapped; chunks do the rest
                        continue
                    if self._paged:
                        # reserve the slot's pages up front; while the pool is
                        # short the request waits (finishing slots free pages,
                        # and a registered prefix may let it attach)
                        self._tables[slot] = self._alloc_pages(self._npp)
                        self._table_valid[slot] = True
                        self._shared_mask[slot] = False
                except paging.PoolExhausted:
                    self.queue.insert(0, req)
                    if obs.active():
                        obs.counter("sched.requeue", scheduler=self.scheduler.name)
                    starved = True
                    break
                refills.append((slot, req, min(n, req.prompt_len)))
        if refills:
            with obs.span("engine.prefill", slots=len(refills),
                          tokens=sum(n for _, _, n in refills)):
                if self._pad_ok:
                    self._prefill_slots(refills)
                else:  # a Mamba state cannot skip pad tokens: one refill a call
                    for one in refills:
                        self._prefill_slots([one])
        chunks = [
            (slot, min(n, self.active[slot].prompt_len - self.active[slot].prefilled))
            for slot, n in plan.chunks
            if self.active[slot] is not None
            and self.active[slot].state == PREFILLING and n > 0
        ]
        decode_slots = tuple(
            s for s in plan.decode
            if self.active[s] is not None and self.active[s].state == DECODING
        )
        if chunks or decode_slots:
            if self._paged:
                with obs.span("engine.cow"):  # before the decode call writes
                    self._cow_writes(
                        [(slot, range(self.active[slot].prefilled,
                                      self.active[slot].prefilled + n))
                         for slot, n in chunks]
                        + [(s, (self.pos[s],)) for s in decode_slots])
            with obs.span("engine.decode", chunks=len(chunks), decode=len(decode_slots)):
                finished = self._chunk_decode(chunks, decode_slots)
            if finished:
                # finishes grouped out of the decode loop, in the emit order
                with obs.span("engine.complete", n=len(finished)):
                    for req, slot in finished:
                        self._finish(req, slot, DONE)
        progress = bool(refills or attached or chunks or decode_slots)
        if starved and not progress:
            # nothing live will ever free a page: a sizing error
            raise paging.PoolExhausted(
                f"page pool ({self.page_pool.num_pages} pages) cannot hold one request "
                f"({self._npp} pages/slot) and no live slot will free any")
        return progress

    def step(self) -> bool:
        """One scheduler-planned step; False when no progress was possible."""
        t0 = self._clock()
        with obs.span("engine.step", step=self.step_index):
            self._sweep_terminal()
            with obs.span("engine.plan"):
                plan = self.scheduler.plan(self._view())
            progressed = self._execute(plan)
            if obs.active():
                self._note_resident_gauges()
        self.step_index += 1
        self.wall_s += self._clock() - t0
        return progressed

    def run(self):
        while self.step():
            pass
        if self._agree_axes():
            self.check_ranks_agree()

    def _agree_axes(self) -> tuple:
        """The mesh's axes above one way, in the mesh's order."""
        if self.view is None:
            return ()
        return tuple(a for a in self.view.axes if self.view.axis(a) is not None)

    def check_ranks_agree(self) -> None:
        """Raise unless every rank of the mesh emitted the same token ids for
        every request (all-gathered over each axis above one way, the last
        first, and compared here)."""
        toks = [t for req in self.requests for t in [req.uid, len(req.out), *req.out]]
        mine = torch.tensor(toks, dtype=torch.int32, device=self.device)
        every = self.view.all_gather(mine[None], self._agree_axes(), dim=0)
        if not bool((every == mine[None]).all()):
            raise RuntimeError(f"the mesh's ranks disagree on their tokens: "
                               f"{every.cpu().numpy().tolist()}")

    def _note_resident_gauges(self) -> None:
        """Gauge the resident weight and cache bytes, as
        :meth:`resident_bytes` counts them."""
        counted = self.resident_bytes()
        obs.gauge("bytes.weights", counted["weights"])
        if self.caches is not None:
            obs.gauge("bytes.cache", counted["cache"])

    def resident_bytes(self) -> dict:
        """``{"weights", "cache", "total"}`` device bytes: the weights through
        each leaf's residency format (counted once: they do not change),
        the live caches through ``kvcache.cache_resident_bytes`` (0 before
        the first refill).  The dry run's ``analytic_weight_bytes`` and
        ``analytic_cache_bytes`` are their twins, to the byte."""
        if self._weight_bytes is None:
            self._weight_bytes = resident_bytes(self.params)
        cache = 0 if self.caches is None else kvcache.cache_resident_bytes(self.caches)
        return {"weights": self._weight_bytes, "cache": cache,
                "total": self._weight_bytes + cache}

    # -- SLO surface ----------------------------------------------------
    def stats(self) -> EngineStats:
        return EngineStats(
            scheduler=self.scheduler.describe(),
            requests=tuple(sched_lib.request_stats(r) for r in self.requests),
            total_tokens=self._total_tokens, wall_s=self.wall_s, work=self.work,
            steps=self.step_index, pages=self._pool_stats(),
        )
