"""The port's example twins on the CPU against the JAX reference, at the
reference examples' sizes.

``repro_torch.examples.quickstart`` (twin of ``examples/quickstart.py``)
trains the reduced qwen3 40 steps, converts it to ``w8a8`` and decodes
greedily.  It starts from the reference trainer's initial weights, in
float32: its loss history must be the reference ``Trainer``'s on the same
batches within ``STEP_RTOL``, its serving half (``quickstart.generate``)
on the reference's trained weights must pick the tokens the reference
example's prefill and decode loop picks, and its own tokens must be what
the engine's greedy serve of its weights gives.

``repro_torch.examples.serve_quantized`` (twin of
``examples/serve_quantized.py``) serves the reference example's weights
(bf16, as the example draws them) with ``--modes`` cut to two formats and
one mixed policy with its cache suffix: every row's greedy tokens must be
the reference ``ServeEngine``'s under the example's settings, every row's
resident bytes the dry run's twins, and the traced all-fused row's
dispatch table must name its three kernels.  On the CPU every kernel
wrapper takes its plain version.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.models import model as ref_model
from repro.serve import engine as ref_engine
from repro.sharding import partitioning as P
from repro.train import trainer as ref_trainer
from repro_torch import convert
from repro_torch.examples import quickstart, serve_quantized
from repro_torch.launch import dryrun
from repro_torch.serve import engine
from repro_torch.train import trainer as trainer_lib
from repro_torch.train import trainstep

jax.config.update("jax_platform_name", "cpu")

#: the trainer tests' tolerance on a step's loss (tests/test_torch_train.py:
#: float32 sums in another order; measured at most 2.4e-7 over the 40 steps)
STEP_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The examples' tensors are small: one intra-op thread (the process's
    count restored after the module), so that the test run's parallel
    workers do not oversubscribe the machine's cores; no result depends on
    it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port_params(ref_params, cfg):
    return convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, ref_params), cfg, "cpu")


def _reference_quickstart_tokens(params, cfg, prompt: np.ndarray) -> list:
    """The reference example's serving half (``examples/quickstart.py``):
    convert to ``w8a8``, prefill, decode 8 tokens greedily."""
    qparams = ref_engine.convert_params(params, cfg, "w8a8", min_dim=16)
    logits, caches = ref_model.prefill(qparams, {"tokens": jnp.asarray(prompt, jnp.int32)}, cfg,
                                       tp=1, max_len=32, impl="jnp")
    toks = [int(jnp.argmax(logits[0, -1]))]
    pos = prompt.shape[1]
    for _ in range(8):
        lg, caches = ref_model.decode_step(qparams, jnp.asarray([[toks[-1]]], jnp.int32), caches,
                                           jnp.int32(pos), cfg, tp=1, impl="jnp")
        toks.append(int(jnp.argmax(lg[0, 0])))
        pos += 1
    return toks


def test_quickstart_trains_converts_and_serves(monkeypatch, capsys):
    rc = ref_smoke_config("qwen3-1.7b").scaled(n_layers=2, vocab_size=256, dtype=jnp.float32)
    ref = ref_trainer.Trainer(
        rc, RefDataConfig(vocab_size=256, seq_len=64, global_batch=8),
        ref_trainer.TrainerConfig(steps=40, log_every=10, peak_lr=3e-3, warmup=5,
                                  ckpt_dir=None)).run()
    init = P.materialize(ref_model.specs(rc, 1), jax.random.PRNGKey(0))  # the reference's draw

    def init_state(tr):
        params = _port_params(init, tr.cfg)
        return params, trainstep.init_opt_state(tr.opt, params, tr.cfg), 0

    smoke = quickstart.get_smoke_config
    monkeypatch.setattr(quickstart, "get_smoke_config",
                        lambda arch: smoke(arch).scaled(dtype=torch.float32))
    monkeypatch.setattr(trainer_lib.Trainer, "init_state", init_state)
    out = quickstart.main(["--device", "cpu"])
    assert [h["step"] for h in out["history"]] == [h["step"] for h in ref["history"]] \
        == [0, 10, 20, 30, 39]
    for mine, theirs in zip(out["history"], ref["history"]):
        assert mine["loss"] == pytest.approx(theirs["loss"], rel=STEP_RTOL), mine["step"]
    assert out["history"][-1]["loss"] < out["history"][0]["loss"]
    assert "quickstart OK" in capsys.readouterr().out

    prompt = np.asarray([out["prompt"]])
    assert len(out["tokens"]) == 9 and prompt.shape == (1, 8)
    assert quickstart.generate(_port_params(ref["params"], out["cfg"]), out["cfg"],
                               torch.from_numpy(prompt), 8) \
        == _reference_quickstart_tokens(ref["params"], rc, prompt)
    eng = engine.ServeEngine(out["params"], out["cfg"], slots=1, max_len=32, mode="w8a8",
                             min_dim=16, device="cpu")
    req = eng.submit(prompt[0].astype(np.int32), len(out["tokens"]))
    eng.run()
    assert req.out == out["tokens"]


def test_serve_quantized_rows_and_traced_excerpt(monkeypatch, capsys):
    rc = ref_smoke_config("qwen3-1.7b").scaled(n_layers=2, vocab_size=256)
    cfg = dataclasses.replace(serve_quantized.get_smoke_config("qwen3-1.7b"), n_layers=2,
                              vocab_size=256)
    ref_params = P.materialize(ref_model.specs(rc, 1), jax.random.PRNGKey(0))  # the example's
    params = _port_params(ref_params, cfg)

    def materialize(c, seed=0, device=None):
        assert (c, seed, device) == (cfg, 0, "cpu")
        return params

    monkeypatch.setattr(serve_quantized.model_lib, "materialize", materialize)
    modes = ["bf16", "w8a8", serve_quantized.MIXED + "+kv:int4_bp"]
    out = serve_quantized.main(["--device", "cpu", "--modes", *modes])
    assert "serve_quantized OK" in capsys.readouterr().out
    assert [r["label"].split("+kv:")[0] for r in out["rows"]] == \
        ["bf16", "w8a8", "ffn=bsdp,mixer=w8a16,default=w8a8"]
    assert out["rows"][0]["agree"] == 1.0
    rng = np.random.default_rng(0)  # the example's six prompts
    prompts = [rng.integers(0, 256, size=(n,)).astype(np.int32)
               for n in rng.integers(4, 12, size=6)]
    for row, entry in zip(out["rows"], modes):
        mode, _, cache = entry.partition("+kv:")
        ref = ref_engine.ServeEngine(ref_params, rc, slots=3, max_len=64, mode=mode,
                                     cache_format=cache or None, scheduler="fcfs", min_dim=16)
        reqs = [ref.submit(p, 8) for p in prompts]
        ref.run()
        assert row["outs"] == [tuple(r.out) for r in reqs], entry
        assert row["tokens"] == 6 * 8
        assert row["weights"] == dryrun.analytic_weight_bytes(cfg, mode, min_dim=16)
        assert row["cache"] == dryrun.analytic_cache_bytes(
            dataclasses.replace(cfg, cache_format=cache or None), 3, 64)
    traced = out["traced"]
    assert traced["records"] > 0 and "engine.step" in traced["spans"]
    assert {dict(k)["kernel"] for k in traced["dispatches"]} == {
        "bsdp_gemm_fused", "dequant_matmul", "plane_decode_attention"}
