"""The port's full-sequence forward (`models/transformer.py forward`,
`Model.apply`) against the reference's, per arch at `reduced()` —
llama2-7b, qwen2-1.5b, gemma2-27b, starcoder2-15b, stablelm-12b and
paligemma-3b with its image prefix — for dense, LCD with the float
transform and LCD with the quantized transform; and within the port:
forward = `decode_step` fed token by token, the rematerialisation policies
and the chunked attention's checkpoints change memory and nothing else.

Tolerances: logits atol 2e-4 (the standard of `tests/test_torch_family.py`;
the reference's LCD leaves run its Pallas kernels in interpret mode, the
port's their plain versions, so the quantized transform sees the same
integers); forward = decode 2e-3 (the reference's
`tests/test_models.py`); remat on = off: logits and gradients rtol 1e-5,
atol 1e-6."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import lut_serving
from repro_torch.convert import from_reference
from repro_torch.models import layers as port_layers
from repro_torch.models import transformer as port_tf
from repro_torch.models.registry import get_model, lm_loss

from _xfw import one_torch_thread  # noqa: F401  (fixture)
from _xfw import (assert_close, cluster_params, np_of, port_model, reference_model,
                  to_numpy_tree)
from test_torch_family import _lively

pytestmark = [pytest.mark.tier1, pytest.mark.usefixtures("one_torch_thread")]

ARCHS = ("llama2-7b", "qwen2-1.5b", "gemma2-27b", "starcoder2-15b", "stablelm-12b",
         "paligemma-3b")
VARIANTS = {"dense": None, "lcd_float": dict(act_scale=None),
            "lcd_quant": dict(act_scale=0.06)}


def _port(tree):
    return from_reference(to_numpy_tree(tree), device="cpu")


def _batch(cfg, rng, b=2, s=12):
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["img_embeds"] = (rng.normal(size=(b, cfg.n_img_tokens, cfg.d_model))
                               * 0.5).astype(np.float32)
    return batch


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_logits_equal_the_reference(arch, variant):
    """`Model.apply` (and `forward`, with the image prefix in front and its
    positions sliced off by apply) on the same converted params and tokens
    as the reference's; gemma2's 12 tokens cross no window of 16, so a
    second batch of 24 tokens does."""
    model, params = reference_model(arch, seed=1, n_layers=2)
    cfg = model.cfg
    params = _lively(params, 17)
    if VARIANTS[variant] is not None:
        params = cluster_params(params, 4, smooth_seed=2, **VARIANTS[variant])
    pmodel = port_model(arch, n_layers=2)
    pparams = _port(params)
    rng = np.random.default_rng(3)
    for s in ((12, 24) if cfg.local_window else (12,)):
        batch = _batch(cfg, rng, s=s)
        with lut_serving("interpret" if variant != "dense" else None):
            want, want_aux = jax.jit(model.apply)(params, {k: jnp.asarray(v)
                                                          for k, v in batch.items()})
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        got, aux = pmodel.apply(pparams, tb)
        assert tuple(got.shape) == (2, s, cfg.padded_vocab) and got.dtype == torch.float32
        assert aux.dtype == torch.float32 and float(aux) == float(want_aux) == 0.0
        assert_close(np_of(got), np.asarray(want), atol=2e-4,
                     what=f"{arch}/{variant} logits, S {s}")
        if cfg.family == "vlm":
            full, _ = port_tf.forward(pparams, tb["tokens"], pmodel.cfg,
                                      prefix_embeds=tb["img_embeds"])
            assert full.shape[1] == cfg.n_img_tokens + s
            assert torch.equal(full[:, cfg.n_img_tokens:], got)
        if cfg.final_softcap:
            assert float(got.abs().max()) <= cfg.final_softcap


@pytest.mark.parametrize("arch", ("llama2-7b", "gemma2-27b", "starcoder2-15b"))
def test_forward_equals_decode_token_by_token(arch):
    """forward's logits at each of 8 positions = the static `decode_step`
    fed one token at a time over a fresh cache (batch 2, f32)."""
    model = port_model(arch, n_layers=2, local_window=4 if arch == "gemma2-27b" else 0)
    _, params = reference_model(arch, seed=4, n_layers=2)
    params = _port(_lively(params, 5))
    tokens = torch.from_numpy(np.random.default_rng(6).integers(
        0, model.cfg.vocab, (2, 8)).astype(np.int32))
    with torch.no_grad():
        logits, _ = model.apply(params, {"tokens": tokens})
    cache = model.init_cache(2, 16, device="cpu")
    for i in range(8):
        lg, cache = model.decode(params, cache, {"tokens": tokens[:, i:i + 1],
                                                 "pos": cache["pos"]})
        assert_close(np_of(lg), np_of(logits[:, i]), atol=2e-3, what=f"{arch} position {i}")
    assert int(cache["pos"]) == 8


def _loss_and_grads(model, params, batch):
    var = {k: v.detach().requires_grad_(True) for k, v in params["blocks"]["attn"].items()}
    p = {**params, "blocks": {**params["blocks"], "attn": var}}
    logits, _ = model.apply(p, batch)
    loss = lm_loss(logits, batch["targets"], batch["loss_mask"], model.cfg.vocab)
    return logits.detach(), torch.autograd.grad(loss, list(var.values()))


def test_remat_policies_change_memory_not_numbers(monkeypatch):
    """`cfg.remat` off, "nothing" and "dots" give the same logits and
    gradients; with grad off no checkpoint runs at all. The chunked
    attention (chunk below Sq) checkpoints each chunk under autograd and
    gives the single-chunk numbers."""
    _, params = reference_model("qwen2-1.5b", seed=2, n_layers=2)
    params = _port(params)
    rng = np.random.default_rng(1)
    base = port_model("qwen2-1.5b", n_layers=2).cfg
    tokens = rng.integers(0, base.vocab, (2, 16)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(tokens),
             "targets": torch.from_numpy(np.roll(tokens, -1, axis=1)),
             "loss_mask": torch.ones(2, 16)}
    runs = {}
    for name, kw in (("off", dict(remat=False)), ("nothing", dict(remat_policy="nothing")),
                     ("dots", dict(remat_policy="dots"))):
        runs[name] = _loss_and_grads(get_model(dataclasses.replace(base, **kw)), params, batch)
    for name in ("nothing", "dots"):
        assert_close(np_of(runs[name][0]), np_of(runs["off"][0]), rtol=1e-5, atol=1e-6,
                     what=f"{name} logits")
        for a, b in zip(runs[name][1], runs["off"][1]):
            assert_close(np_of(a), np_of(b), rtol=1e-5, atol=1e-6, what=f"{name} grads")
    with pytest.raises(ValueError, match="remat_policy"):
        _loss_and_grads(get_model(dataclasses.replace(base, remat_policy="all")), params, batch)

    calls = []
    real = port_tf._remat_block
    monkeypatch.setattr(port_tf, "_remat_block", lambda *a: calls.append(1) or real(*a))
    with torch.no_grad():
        get_model(base).apply(params, batch)
    assert not calls
    _loss_and_grads(get_model(base), params, batch)
    assert len(calls) == base.n_layers

    q = torch.from_numpy(rng.normal(size=(2, 16, 4, 32)).astype(np.float32)).requires_grad_(True)
    k = torch.from_numpy(rng.normal(size=(2, 16, 2, 32)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(2, 16, 2, 32)).astype(np.float32))
    outs = [port_layers.attention(q, k, v, chunk=c, window=6) for c in (16, 4)]
    grads = [torch.autograd.grad(o.square().sum(), q)[0] for o in outs]
    assert_close(np_of(outs[1]), np_of(outs[0]), rtol=1e-6, atol=1e-7, what="chunked attention")
    assert_close(np_of(grads[1]), np_of(grads[0]), rtol=1e-5, atol=1e-6, what="its gradient")
