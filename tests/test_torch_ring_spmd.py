"""The port's sequence parallelism and 4-axis GPT step against the JAX
package: ``build_spmd_train_step`` at (dp, pp, sp, mp) = (1, 2, 2, 2) on
eight gloo ranks from JAX's ``init_params`` (the loss and every updated
parameter, in f32, against JAX's step on its 8 virtual devices; the
bf16 loss against the f32 one; ``reference_loss``), and ring attention at sp = 2, causal and
full, outputs and gradients, against JAX's ``ring_attention`` and, at
tests/test_ring_flash.py's [1, 2, 1024, 64], against JAX's flash-block
ring in Pallas interpret mode.

One job of eight ranks (`tests/torch_hybrid_runner.py:spmd_worker`),
started once a session.  Tolerances: the f32 step's loss 1e-5 relative
and parameters 1e-5 absolute against JAX's step (JAX's own bar against
the dense reference is 1e-3 / 2e-3); the bf16 loss 2e-2 relative of
the f32 loss;
``reference_loss`` 1e-5; ring attention 1e-5 (outputs) and 1e-4
(gradients), the flash-block ring 1e-4 and 1e-3 (interpret-mode blocks
against the port's composed blocks).
"""
import importlib
import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.sharding import Mesh

from paddle_tpu.distributed.topology import build_mesh
from paddle_tpu.models import gpt_spmd as JS
from paddle_tpu.models.gpt import GPTConfig

JR = importlib.import_module("paddle_tpu.parallel.ring_attention")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_hybrid_runner as R  # noqa: E402
from torch_hybrid_common import shared_run  # noqa: E402


def _ring_inputs(prefix, shape, seed):
    rng = np.random.RandomState(seed)
    return {f"{prefix}_{n}": rng.randn(*shape).astype(np.float32)
            for n in ("q", "k", "v", "g")}


def _inputs():
    cfg = GPTConfig(**R.SPMD_CFG)
    params = JS.init_params(cfg, jax.random.PRNGKey(0))
    a = {f"p.{k}": np.asarray(v, np.float32) for k, v in params.items()}
    rng = np.random.RandomState(1)
    a["tokens"] = rng.randint(0, 32, (4, 16)).astype(np.int64)
    a["labels"] = rng.randint(0, 32, (4, 16)).astype(np.int64)
    a.update(_ring_inputs("ring2", (2, 2, 32, 8), 2))
    a.update(_ring_inputs("flash", (1, 2, 1024, 64), 3))
    return a


@pytest.fixture(scope="module")
def spmd(tmp_path_factory):
    return shared_run(tmp_path_factory, "spmd", R.spmd_worker, 8,
                      lambda out: np.savez(out + ".npz", **_inputs()))


def _jax_step(dtype):
    a = _inputs()
    cfg = GPTConfig(**R.SPMD_CFG)
    params = {k[2:]: jnp.asarray(v) for k, v in a.items()
              if k.startswith("p.")}
    step = JS.build_spmd_train_step(cfg, build_mesh(dp=1, pp=2, sp=2, mp=2),
                                    num_micro=2, lr=0.1,
                                    compute_dtype=dtype)
    loss, new = step(params, jnp.asarray(a["tokens"], jnp.int32),
                     jnp.asarray(a["labels"], jnp.int32))
    ref = JS.reference_loss(cfg, params, jnp.asarray(a["tokens"]),
                            jnp.asarray(a["labels"]))
    return float(loss), {k: np.asarray(v) for k, v in new.items()}, \
        float(ref)


def test_spmd_step_f32_matches_jax(spmd):
    loss, new, ref = _jax_step(jnp.float32)
    coords = set()
    for res in spmd:
        coords.add(tuple(res["coords"]))
        np.testing.assert_allclose(res["loss"], loss, rtol=1e-5)
        np.testing.assert_allclose(res["reference_loss"], ref, rtol=1e-5)
        np.testing.assert_allclose(res["loss"], ref, rtol=1e-3)
        assert sorted(res["new_params"]) == sorted(new)
        for k, v in new.items():
            np.testing.assert_allclose(res["new_params"][k], v, atol=1e-5,
                                       err_msg=k)
    assert len(coords) == 8


def test_spmd_local_shards_follow_train_rules(spmd):
    h, nl, v = 16, 2, 32
    for res in spmd:
        sh = res["local_shapes"]
        assert sh["wte"] == [v // 2, h]            # ("mp", None)
        assert sh["w_qkv"] == [nl // 2, h, 3 * h // 2]   # ("pp", None, "mp")
        assert sh["w_out"] == [nl // 2, h // 2, h]       # ("pp", "mp", None)
        assert sh["b_out"] == [nl // 2, h]               # ("pp", None)
        assert sh["lm_head"] == [h, v // 2]              # (None, "mp")
        assert sh["wpe"] == [16, h] and sh["lnf_w"] == [h]
        # two micro-batches cross the stage boundary, forward and back
        st = res["pp_stats"]
        stage = res["coords"][1]
        assert st["sends"] == 2 + (2 if stage == 0 else 0)
        assert st["recvs"] == 2 + (2 if stage == 1 else 0)


def test_spmd_step_bf16_loss(spmd):
    """The bf16 step (the default ``compute_dtype``, as in JAX) against the
    f32 loss: bf16 products and activations move a loss of ~3.5 by well
    under 2e-2 relative."""
    for res in spmd:
        assert res["loss_bf16"] != res["loss"]
        np.testing.assert_allclose(res["loss_bf16"], res["loss"], rtol=2e-2)


def _jax_ring(q, k, v, g, mesh, causal):
    @jax.jit
    def fwd_bwd(q, k, v, g):
        out, vjp = jax.vjp(lambda q, k, v: JR.ring_attention(
            q, k, v, mesh, axis_name="sp", causal=causal), q, k, v)
        return out, vjp(g)

    return fwd_bwd(q, k, v, g)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_sp2_matches_jax(spmd, causal):
    a = _inputs()
    out, grads = _jax_ring(*(jnp.asarray(a[f"ring2_{n}"]) for n in "qkvg"),
                           build_mesh(sp=2), causal)
    for res in spmd:
        got = res["ring2"][causal]
        np.testing.assert_allclose(got["out"], np.asarray(out), atol=1e-5)
        for gg, want in zip(got["grads"], grads):
            np.testing.assert_allclose(gg, np.asarray(want), atol=1e-4)


@pytest.fixture
def flash_ring_interpret(monkeypatch):
    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)
    monkeypatch.setattr(
        JR, "_use_flash_blocks",
        lambda q, s: q.shape[-2] % 512 == 0 and q.shape[-1] % 64 == 0
        and isinstance(s, (int, float)))
    yield


@pytest.mark.parametrize("causal", [False, True])
def test_flash_block_ring_matches_jax_interpret(spmd, flash_ring_interpret,
                                                causal):
    a = _inputs()
    mesh = Mesh(np.array(jax.devices()[:2]), ("sp",))
    out, grads = _jax_ring(*(jnp.asarray(a[f"flash_{n}"]) for n in "qkvg"),
                           mesh, causal)
    for res in spmd:
        got = res["flash_ring"][causal]
        np.testing.assert_allclose(got["out"], np.asarray(out), atol=1e-4)
        for gg, want in zip(got["grads"], grads):
            np.testing.assert_allclose(gg, np.asarray(want), atol=1e-3)
