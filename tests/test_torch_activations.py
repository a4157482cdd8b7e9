"""The port's bf16 activations and softcap against the reference's, bit for
bit on every finite bf16 value (CPU).

``models.common.silu``, ``gelu_tanh`` and ``softplus`` round each op to
bf16 in the order jax lowers ``jax.nn.silu``, ``jax.nn.gelu(approximate=
True)`` and ``jax.nn.softplus`` to, and ``softcap`` rounds its cap to
bf16 first, as JAX rounds the weak-typed scalar.  All 65,280 finite bf16
values (the 65,536 bit patterns less NaN and the infinities) go through
both, and the bits must be equal.

XLA's CPU code flushes subnormal floats to zero (inputs and results),
torch's does not unless ``torch.set_flush_denormal(True)``.  So each value
whose op chain in the port touches the subnormal range (the input, or an
op's result at or below 2**-126 in magnitude: a result rounded up to the
smallest normal came from a subnormal float32) is compared with torch
flushing subnormals, as XLA does; every other value in torch's default
mode.  The one-call ``torch.nn.functional`` forms and the unrounded cap
differ on hundreds to thousands of values and must fail the check.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from repro.models import common as jcommon
from repro_torch.models import common as tcommon

torch.set_num_threads(1)        # the flush mode is set on this thread

TINY = 2.0 ** -126              # the smallest normal float32 / bf16


def _finite_bf16():
    bits = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
    vals = bits.view(ml_dtypes.bfloat16)
    return vals[np.isfinite(vals.astype(np.float32))]


VALUES = _finite_bf16()


class _Results(TorchFunctionMode):
    """Records the result of every torch op of the port's helper."""

    def __init__(self):
        super().__init__()
        self.results = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if isinstance(out, torch.Tensor) and out.shape == VALUES.shape:
            self.results.append(out.detach().to(torch.float32))
        return out


def _touches_subnormal(t: torch.Tensor) -> torch.Tensor:
    a = t.abs()
    return (a > 0) & (a <= TINY)


def _differing(fn, want):
    """The values on which ``fn``'s bits differ from ``want``'s, each in
    the float mode described above; and the count of flushed values."""
    x = torch.from_numpy(VALUES.view(np.int16).copy()).view(torch.bfloat16)
    want = np.asarray(want).view(np.uint16)
    with _Results() as rec:
        got = fn(x)
    flushed = _touches_subnormal(x.to(torch.float32))
    for r in rec.results:
        flushed |= _touches_subnormal(r)
    flushed = flushed.numpy()
    plain = got.view(torch.int16).numpy().view(np.uint16)
    torch.set_flush_denormal(True)
    try:
        flush = fn(x).view(torch.int16).numpy().view(np.uint16)
    finally:
        torch.set_flush_denormal(False)
    bad = np.where(flushed, flush != want, plain != want)
    return VALUES[bad], int(flushed.sum())


ACTIVATIONS = {
    "silu": (tcommon.silu, F.silu, jax.nn.silu),
    "gelu_tanh": (tcommon.gelu_tanh, lambda x: F.gelu(x, approximate="tanh"),
                  lambda x: jax.nn.gelu(x, approximate=True)),
    "softplus": (tcommon.softplus, F.softplus, jax.nn.softplus),
}


@pytest.mark.parametrize("name", sorted(ACTIVATIONS))
def test_bf16_activation_is_the_reference_bit_for_bit(name):
    port, one_call, ref = ACTIVATIONS[name]
    want = ref(jnp.asarray(VALUES))
    assert VALUES.size == 65280 and want.dtype == jnp.bfloat16
    bad, flushed = _differing(port, want)
    assert bad.size == 0, (bad[:8], bad.size)
    assert flushed < 3000
    # the one-call form rounds once: the check must catch it
    old, _ = _differing(one_call, want)
    assert old.size > 500, old.size


@pytest.mark.parametrize("name", sorted(ACTIVATIONS))
def test_float32_activation_is_one_call(name):
    """float32 keeps the one-call ``torch.nn.functional`` form."""
    port, one_call, ref = ACTIVATIONS[name]
    x = torch.linspace(-30, 30, 4001, dtype=torch.float32)
    assert torch.equal(port(x), one_call(x))
    np.testing.assert_allclose(port(x).numpy(),
                               np.asarray(ref(jnp.asarray(x.numpy()))),
                               rtol=2e-6, atol=1e-6)


@pytest.mark.parametrize("cap", [7.3, 0.3])
def test_bf16_softcap_rounds_its_cap_as_the_reference(cap):
    """Caps that bf16 does not hold exactly (7.3 -> 7.3125, 0.3 ->
    0.30078125): the port's softcap equals the reference's on every
    finite bf16 logit; ``cap * tanh(x / cap)`` with the unrounded cap
    differs on thousands of them."""
    want = jcommon.softcap(jnp.asarray(VALUES), cap)
    assert want.dtype == jnp.bfloat16
    bad, _ = _differing(lambda x: tcommon.softcap(x, cap), want)
    assert bad.size == 0, (bad[:8], bad.size)
    old, _ = _differing(lambda x: cap * torch.tanh(x / cap), want)
    assert old.size > 1000, old.size
    assert tcommon.dtype_scalar(cap, torch.bfloat16) != cap
