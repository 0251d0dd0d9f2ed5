"""One rank of the port's tensor-parallel CPU tests (``tests/test_torch_tp.py``).

Run as ``python tests/_torch_tp_rank.py '<json>'`` with ``rank``, ``world``,
``port`` and ``workdir``: the rank joins a gloo process group on
``tcp://localhost:<port>``, builds a ``(data=1, model=world)`` mesh, reads
the reference's float parameters (``workdir/params.npz``, the reference's
``materialize(specs(cfg, world))`` in its stacked layout) and writes what it
computed to ``workdir/rank<r>.npz``.  It imports only ``repro_torch``,
torch and numpy; the test module imports this one for the shared inputs.
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
    code that differs."""

    def __init__(self, ref, quant):
        self.ref, self.calls, self.forced, self.far = ref, 0, 0, 0
        self._quant, self._quantize = quant, quant.quantize
        quant.quantize = self.quantize

    def restore(self):
        self._quant.quantize = self._quantize

    def quantize(self, x, *, bits=8, axis=-1, scale=None):
        import dataclasses

        qt = self._quantize(x, bits=bits, axis=axis, scale=scale)
        v_ref, q_ref = (a.reshape(-1) for a in self.ref[self.calls])
        self.calls += 1
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


def _prefill_decode(eng, model_lib, vocab: int) -> dict:
    toks, pos, steps, step_pos = prefill_inputs(vocab)
    batch = {"tokens": torch.from_numpy(toks).long(), "positions": torch.from_numpy(pos)}
    logits, caches = model_lib.prefill(eng.params, batch, eng.cfg, max_len=MAX_LEN,
                                       tp=eng._tp)
    out = [logits[:, -1].numpy()]
    for tok, p in zip(steps, step_pos):
        logits, caches = model_lib.decode_step(eng.params, torch.from_numpy(tok[:, None]).long(),
                                               caches, torch.from_numpy(p), eng.cfg,
                                               tp=eng._tp)
        out.append(logits[:, -1].numpy())
    return {"logits": np.stack(out)}


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
        out[f"pd/{stack}"] = _prefill_decode(build(stack), model_lib, cfg.vocab_size)["logits"]
    for stack in SERVED:
        eng = build(stack)
        reqs = schedule(eng, cfg.vocab_size)
        out[f"serve/{stack}/tokens"] = np.array([t for r in reqs for t in r.out])
        out[f"serve/{stack}/logits"] = np.concatenate(
            [np.reshape(lg, (-1, lg.shape[-1])) for _, _, lg in eng.logit_trace])
        out[f"serve/{stack}/kinds"] = np.array([f"{k}{list(s)}" for k, s, _ in eng.logit_trace])
        out[f"serve/{stack}/bytes"] = np.array(eng.resident_bytes()["weights"])
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
    deadline = time.monotonic() + CODES_WAIT_S
    while not os.path.exists(f"{workdir}/codes_A.npz"):
        if time.monotonic() > deadline:
            raise TimeoutError(f"no reference codes after {CODES_WAIT_S} s")
        time.sleep(0.2)
    with np.load(f"{workdir}/codes_A.npz") as z:
        ref_codes = [(z[f"v{i}"], z[f"q{i}"]) for i in range(len(z.files) // 2)]
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
