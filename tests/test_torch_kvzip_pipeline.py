"""The KVzip-family presses (KVzip, KVzip+, RestoreKV, FastKVzip) of
kvpress_tpu_torch through its pipeline against the JAX pipeline on the same
weights and inputs (CPU, float32, tiny config; the port on its kernel
routes, whose plain versions run here): the answers, the compressed cache's
lengths and its keep bits equal, one-shot and with ``context_chunk``, over
float32, int8 and int4 KV; RestoreKV's budget-matched eviction;
``compact=True`` on the head-wise runner against the mask-only press; the
refusals on both sides. JAX's artifacts reach the port through the ``.npz``
files (tests/torch_multipass_cases.py). The units are in
tests/test_torch_kvzip.py.

On a quantized cache a repeat prompt of at most 128 tokens takes the decode
kernel's route on the port's flash runner, which reads the repeat block back
through the quantizer; JAX's dense route reads it exact. The KVzip+ case over
quantized KV therefore runs the port with ``decode_kernel=False`` (the repeat
prompt then takes flash over the dense buffer, as it does at full size)."""

import pytest
import torch

from kvpress_tpu import presses as jp
import kvpress_tpu_torch as kt
from torch_multipass_cases import Pipelines, artifacts, assert_same, make_press, valid_mask

torch.set_num_threads(2)

S = 60


@pytest.fixture(scope="module")
def pipes():
    return Pipelines.tiny()


@pytest.fixture(scope="module")
def art(pipes, tmp_path_factory):
    return artifacts(pipes.cfg_j, tmp_path_factory.mktemp("multipass"))


PIPELINE_CASES = [
    ("kvzip", {}), ("kvzip", dict(context_chunk=16)), ("kvzip", dict(quantized=True)),
    ("kvzip", dict(quantized=True, kv_bits=4, context_chunk=16)),
    ("kvzip_plus", {}), ("kvzip_plus", dict(quantized=True, context_chunk=16, decode_kernel=False)),
    ("kvzip_layerwise", {}), ("kvzip_compact", dict(headwise=True)),
    ("restorekv", {}), ("restorekv", dict(quantized=True, context_chunk=16)),
    ("restorekv_plus", {}),
    ("fastkvzip", {}), ("fastkvzip", dict(context_chunk=16)),
    ("fastkvzip", dict(quantized=True)), ("fastkvzip_layerwise", {}),
    ("fastkvzip_compact", dict(headwise=True)),
]


@pytest.mark.parametrize("name,kw", PIPELINE_CASES,
                         ids=[f"{n}-{'-'.join(f'{k}={v}' for k, v in kw.items()) or 'default'}"
                              for n, kw in PIPELINE_CASES])
def test_pipeline_matches_jax(pipes, art, name, kw):
    """Answers, the compressed cache's lengths (RestoreKV: 60 + 8 restore
    slots) and its keep bits equal JAX's."""
    out = pipes.run(make_press(jp, name, art["jax"]), make_press(kt, name, art["torch"]), **kw)
    assert_same(out)
    lengths, mask = out["torch"][1:]
    if name.startswith("restorekv"):
        assert lengths == [S + 8] * len(lengths)
        # budget-matched: (ratio + 8 / 60) of the context's slots masked
        frac = (~valid_mask(mask, lengths)[..., :S]).mean()
        assert abs(frac - (0.5 + 8 / S)) < 0.02, frac


@pytest.mark.parametrize("name", ["kvzip", "fastkvzip"])
def test_compact_answers_equal_mask_only(pipes, art, name):
    """compact=True on the head-wise runner answers as the mask-only press
    on the decode kernel's runner."""
    context, question = pipes.context()
    mask_only = pipes.torch_pipe()(context, question=question, max_new_tokens=8,
                                   press=make_press(kt, name, art["torch"]))
    compact = pipes.torch_pipe(headwise=True)(context, question=question, max_new_tokens=8,
                                              press=make_press(kt, name + "_compact",
                                                               art["torch"]))
    assert compact == mask_only


def test_refusals_on_both_sides(pipes, art):
    """A bucket with a multi-pass or post-mask press (both packages)."""
    context, question = pipes.context()
    tpipe, jpipe = pipes.torch_pipe(), pipes.jax_pipe()
    for name in ("kvzip", "restorekv", "fastkvzip"):
        with pytest.raises(ValueError, match="multi-pass"):
            tpipe(context, question=question, press=make_press(kt, name, art["torch"]),
                  context_bucket=32)
        with pytest.raises(AssertionError, match="multi-pass"):
            jpipe(context, question=question, press=make_press(jp, name, art["jax"]),
                  context_bucket=32)
    with pytest.raises(ValueError):
        kt.KVzipPress(1.0)
    with pytest.raises(TypeError, match="kvzip_spec"):
        kt.Runner.create(pipes.cfg_t, device="cpu")._chunk_forward_lean(
            pipes.params_t, torch.zeros((1, 4), dtype=torch.long),
            kt.init_cache(pipes.cfg_t, 1, 16, dtype=torch.float32, device="cpu"),
            kvzip_spec=(0, 0))
