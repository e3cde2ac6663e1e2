"""ssdx_torch.ops.int8_conv against the JAX package's Pallas int8 kernels,
run in interpret mode on the CPU.

On the CPU the port's wrappers run their plain versions, which are what is
compared here; the CUDA kernels run only on the card, where chip_smoke.py
holds them against these same plain versions bit for bit.  Limits are the
JAX suite's own (tests/test_pallas_int8_conv.py): the contraction is exact
integer math on both sides, but XLA may fuse the epilogue's multiply and
add into an FMA, which moves a float32 by one unit in the last place and,
on a rounding boundary, a requantized value by one int8 step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssdx import quant as jq
from ssdx.export import fold_batchnorm as jax_fold
from ssdx.ops.pallas_int8_conv import apply_int8_pallas
from ssdx.ops.pallas_int8_conv import int8_conv as jax_int8_conv
from ssdx_torch import quant as tq
from ssdx_torch.ops import int8_conv as ic
from ssdx_torch.weights import quant_from_jax
from torch_parity import random_variables

CASES = [
    # (name, H, cin, cout, k, stride, dilation, pad): tests/test_pallas_int8_conv.py:41-48
    ("same_3x3", 14, 16, 32, 3, 1, 1, 1),
    ("dilated", 13, 24, 16, 3, 1, 2, 2),
    ("stride2", 11, 16, 24, 3, 2, 1, 1),
    ("valid", 9, 16, 16, 3, 1, 1, 0),
    ("one_by_one", 7, 32, 16, 1, 1, 1, 0),
]


def _layer(seed, H, cin, cout, k):
    rng = np.random.default_rng(seed)
    return dict(
        xq=rng.integers(-127, 128, (2, H, H, cin)).astype(np.int8),
        kq=rng.integers(-127, 128, (k, k, cin, cout)).astype(np.int8),  # HWIO
        ws=rng.uniform(1e-3, 2e-3, cout).astype(np.float32),
        b=rng.normal(0, 0.1, cout).astype(np.float32),
        ns=rng.uniform(0.01, 0.05, cout).astype(np.float32))


def _torch_args(d):
    t = torch.as_tensor
    kq = t(d["kq"]).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    return t(d["xq"]), kq, t(d["ws"]), t(d["b"]), t(d["ns"])


def _check(got, want, kind, name):
    g, w = got.numpy(), np.asarray(want)
    assert g.shape == w.shape, (name, g.shape, w.shape)
    if kind == "f32":
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-4)
    else:
        assert g.dtype == np.int8
        diff = np.abs(g.astype(np.int32) - w.astype(np.int32))
        assert diff.max() <= 1, (name, diff.max())      # one int8 step at most
        assert (diff != 0).mean() < 0.01, (name, (diff != 0).mean())  # on under 1 %


@pytest.mark.parametrize("emit", ["int8", "f32", "both"])
@pytest.mark.parametrize("name,H,cin,cout,k,stride,dilation,pad", CASES)
def test_int8_conv_ref_matches_pallas(name, H, cin, cout, k, stride, dilation, pad, emit):
    d = _layer(len(name) + H, H, cin, cout, k)
    kw = dict(stride=stride, dilation=dilation, pad=pad, emit=emit)
    want = jax_int8_conv(jnp.asarray(d["xq"]), jnp.asarray(d["kq"]), jnp.asarray(d["ws"]),
                         jnp.asarray(d["b"]), None if emit == "f32" else jnp.asarray(d["ns"]),
                         interpret=True, **kw)
    xq, kq, ws, b, ns = _torch_args(d)
    got = ic.int8_conv_ref(xq, kq, ws, b, None if emit == "f32" else ns, **kw)
    if emit == "both":
        _check(got[0], want[0], "int8", name)
        _check(got[1], want[1], "f32", name)
    else:
        _check(got, want, emit, name)


def test_int8_conv_ref_bf16_tap_is_f32_tap_rounded_once():
    d = _layer(1, 9, 16, 16, 3)
    xq, kq, ws, b, ns = _torch_args(d)
    q, tap = ic.int8_conv_ref(xq, kq, ws, b, ns, pad=1, emit="both", tap_dtype=torch.bfloat16)
    f32 = ic.int8_conv_ref(xq, kq, ws, b, pad=1, emit="f32")
    assert tap.dtype == torch.bfloat16 and q.dtype == torch.int8
    torch.testing.assert_close(tap, f32.to(torch.bfloat16), rtol=0, atol=0)


def test_wrapper_runs_plain_version_on_cpu():
    d = _layer(2, 9, 16, 32, 3)
    args = _torch_args(d)
    before = (ic.launches, ic.launches_conv3, ic.launches_mm)
    got = ic.int8_conv(*args, stride=2, pad=1, emit="both")
    assert (ic.launches, ic.launches_conv3, ic.launches_mm) == before  # no kernel on the CPU
    want = ic.int8_conv_ref(*args, stride=2, pad=1, emit="both")
    assert got[0].shape == (2, 5, 5, 32)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_wrapper_refuses_other_devices_and_bad_emit():
    d = _layer(3, 7, 16, 16, 3)
    args = _torch_args(d)
    with pytest.raises(ValueError, match="unsupported device"):
        ic.int8_conv(*[a.to("meta") for a in args], pad=1)
    with pytest.raises(ValueError, match="emit"):
        ic.int8_conv(*args, pad=1, emit="int4")
    with pytest.raises(ValueError, match="next_in_scale"):
        ic.int8_conv(*args[:4], pad=1, emit="int8")


@pytest.mark.parametrize("fn,ref,dtype", [
    (ic.int8_mm_raw, ic.int8_mm_raw_ref, torch.int8),
    (ic.bf16_mm_raw, ic.bf16_mm_raw_ref, torch.bfloat16)])
def test_bare_matmuls_on_cpu(fn, ref, dtype):
    """The bare matmuls' plain versions against numpy (int8: exact; bf16
    operands with float32 sums: 1e-5 relative), and no launch on the CPU."""
    rng = np.random.default_rng(4)
    a8 = rng.integers(-127, 128, (48, 64)).astype(np.int8)
    b8 = rng.integers(-127, 128, (32, 64)).astype(np.int8)
    if dtype == torch.int8:
        a, b_t = torch.as_tensor(a8), torch.as_tensor(b8)
        want = a8.astype(np.int64) @ b8.astype(np.int64).T
    else:
        a = (torch.as_tensor(a8).float() / 127).to(dtype)
        b_t = (torch.as_tensor(b8).float() / 127).to(dtype)
        want = a.double().numpy() @ b_t.double().numpy().T
    before = ic.launches_raw
    got = fn(a, b_t)
    assert ic.launches_raw == before
    assert got.shape == (48, 32)
    torch.testing.assert_close(got, ref(a, b_t), rtol=0, atol=0)
    if dtype == torch.int8:
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="unsupported device"):
        fn(a.to("meta"), b_t.to("meta"))


def test_apply_int8_kernels_matches_pallas_walk():
    """The whole walk at width 0.25, B=1, float32 heads: apply_int8_kernels
    (on the CPU: every layer through int8_conv's plain version) against
    apply_int8_pallas(interpret=True), the weights carried by quant_from_jax.
    Heads within 0.25 absolute and under 1 % of elements past 0.05, as
    tests/test_pallas_int8_conv.py:112-115.  It must also track the port's
    own plain walk, which divides where this one multiplies by the
    reciprocal: same limits."""
    rng = np.random.default_rng(13)
    params = jax_fold(random_variables(0.25, seed=5))["params"]
    feats = rng.uniform(0, 4, (1, 150, 150, 16)).astype(np.float32)
    amax = {s.name: rng.uniform(0.05, 6.0, params[s.name]["Conv_0"]["kernel"].shape[2])
            .astype(np.float32) for s in jq._TOPOLOGY}
    amax["ConvBNRelu_2"][:] = 4.0  # the range of feats
    jqp = jq.quantize_ssd(params, amax, 6)
    ref_loc, ref_cls = jax.jit(
        lambda f: apply_int8_pallas(jqp, f, jnp.float32, interpret=True))(jnp.asarray(feats))

    qp = quant_from_jax(jqp)
    before = ic.launches
    loc, cls = ic.apply_int8_kernels(qp, torch.as_tensor(feats), torch.float32)
    assert ic.launches == before
    assert loc.shape == (1, 8732, 4) and cls.shape == (1, 8732, 6)
    ploc, pcls = tq.apply_int8(qp, torch.as_tensor(feats), torch.float32, compute="int32")
    for g, refs in ((loc, (ref_loc, ploc)), (cls, (ref_cls, pcls))):
        assert torch.isfinite(g).all()
        for r in refs:
            diff = np.abs(g.numpy() - np.asarray(r))
            assert diff.max() <= 0.25, diff.max()
            assert (diff > 0.05).mean() < 0.01, (diff > 0.05).mean()
