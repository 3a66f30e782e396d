"""Activation checkpointing (``ModelConfig.remat``, the JAX package's
``_maybe_remat``): for every family, the loss and every gradient with
``remat="block"`` equal ``"none"``'s bit for bit on the CPU (the
recomputation repeats the forward's arithmetic), stay within
``tests/test_torch_train_step.py``'s tolerances of ``jax.grad`` (JAX's
reduced configs keep its default, ``remat="block"``), and the backward
does recompute: each stacked layer's kernels run twice."""

import dataclasses

import pytest
import torch

from repro_torch import convert
from repro_torch.configs import get_config as tget
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import ssd_scan as tssd
from repro_torch.launch import steps as tsteps
from repro_torch.models import build_model as tbuild
from repro_torch.models.config import ModelConfig
from test_torch_train_step import (ARCHS, LOSS_RTOL, batch_arrays,
                                   close_trees, jax_case, need_jax,
                                   to_numpy, torch_batch, zero_grad_bias)


def port_case(arch, remat):
    cfg = dataclasses.replace(tget(arch).reduced(dtype="float32"),
                              remat=remat)
    model = tbuild(cfg)
    params = model.init(torch.Generator().manual_seed(3))
    return model, params, torch_batch(batch_arrays(arch))


def loss_and_grads(model, params, batch):
    return tsteps._loss_and_grads(model, params, batch, 1.0,
                                  lambda _: None)


@pytest.mark.parametrize("arch", ARCHS)
def test_block_equals_none_bit_for_bit(arch, monkeypatch):
    calls = {"flash": 0, "ssd": 0}
    flash, ssd = tflash.flash_attention, tssd.ssd_state_scan

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(tflash, "flash_attention", count("flash", flash))
    monkeypatch.setattr(tssd, "ssd_state_scan", count("ssd", ssd))
    out = {}
    for remat in ("none", "block"):
        calls.update(flash=0, ssd=0)
        model, params, batch = port_case(arch, remat)
        loss, grads = loss_and_grads(model, params, batch)
        out[remat] = (loss, grads, dict(calls))
    (l0, g0, c0), (l1, g1, c1) = out["none"], out["block"]
    assert torch.equal(l0, l1)
    assert len(g0) == len(g1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)
    # the backward re-runs each stacked layer's forward (the encoder's
    # and decoder's layers for whisper; zamba2's shared block and a MoE
    # model's leading dense layers are not checkpointed, as in JAX)
    assert c1["flash"] > c0["flash"] or c1["ssd"] > c0["ssd"]
    cfg = model.cfg
    if cfg.family == "ssm":
        assert c1["ssd"] == 2 * c0["ssd"]
    elif cfg.family in ("dense", "vlm"):
        assert c1["flash"] == 2 * c0["flash"]


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "zamba2-2.7b",
                                  "kimi-k2-1t-a32b", "whisper-large-v3"])
def test_block_within_jax_grad_tolerance(arch):
    need_jax()
    _, params, batch, want_loss, want_grads = jax_case(arch)
    model = tbuild(tget(arch).reduced(dtype="float32"))
    assert model.cfg.remat == "block"
    tparams = convert.lm_params_from_numpy(to_numpy(params), "cpu")
    loss, grads = loss_and_grads(model, tparams, torch_batch(batch))
    assert loss.item() == pytest.approx(float(want_loss), rel=LOSS_RTOL)
    close_trees(grads, want_grads, zero=zero_grad_bias(arch))


def test_remat_modes():
    cfg = tget("qwen3-0.6b")
    assert cfg.remat == "block"
    assert dataclasses.replace(cfg, remat="full").remat == "full"
    with pytest.raises(ValueError, match="remat"):
        dataclasses.replace(cfg, remat="sometimes")
    assert "remat" in {f.name for f in dataclasses.fields(ModelConfig)}


def test_no_checkpoint_without_autograd():
    """A forward under ``no_grad`` (serving, prefill) runs each layer once
    whatever ``remat`` says."""
    model, params, batch = port_case("qwen3-0.6b", "block")
    with torch.no_grad():
        a = model.loss(params, batch)
    b = tbuild(dataclasses.replace(model.cfg, remat="none")).loss(params,
                                                                   batch)
    assert torch.equal(a, b.detach())
