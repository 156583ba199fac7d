"""The LM half's kernel modules and building blocks of the PyTorch port,
on the CPU, against the JAX reference.

Inputs come from a numpy seed and go through both packages. The plain
versions of the two kernels are held to the reference's Pallas kernels
run in interpret mode: flash attention on the shapes of
tests/test_kernels.py (rtol 2e-4, atol 2e-5, that file's tolerance), the
SSD scan likewise (rtol = atol = 2e-4) and against the port's own chunked
form. The building blocks are held to the reference at rtol 1e-5 in f32
(atol 1e-6 where a value may be near zero). The CUDA kernels themselves
are held to these plain versions on the card (tests/test_torch_gpu.py,
chip_smoke.py).
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core.config import Variant as JVariant  # noqa: E402
from repro.kernels.flash_attention import flash_attention as j_flash  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as j_ssd  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import common as j_common  # noqa: E402
from repro.models import ssm as j_ssm  # noqa: E402

from repro_torch import kernels  # noqa: E402
from repro_torch.core.config import Variant  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: E402
from repro_torch.models import attention, common, ssm  # noqa: E402

T = torch.as_tensor


def _close(out, ref, rtol=1e-5, atol=1e-6):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    np.testing.assert_allclose(out, ref, rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,l,hq,hkv,d,causal", [
    (1, 64, 2, 2, 16, True),
    (2, 96, 4, 2, 32, True),     # GQA + ragged (a partial tile)
    (1, 128, 4, 1, 64, True),    # MQA
    (2, 64, 2, 2, 16, False),    # non-causal, aligned
])
def test_flash_plain_matches_reference_kernel(b, l, hq, hkv, d, causal):
    rng = np.random.default_rng(l * hq + d)
    q = rng.standard_normal((b, l, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, l, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, l, hkv, d)).astype(np.float32)
    ref = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=causal, bq=32, bk=32)
    kernels.reset_launch_counts()
    out = flash_attention(T(q), T(k), T(v), causal=causal)
    assert out.dtype == torch.float32
    assert kernels.launch_counts()["flash_attention"] == 0   # CPU: plain
    _close(out, ref, rtol=2e-4, atol=2e-5)


def test_flash_refuses_what_the_reference_refuses():
    """Non-causal with a ragged Lk: the reference raises ValueError
    (its padded keys would enter the softmax), and so does the port."""
    q = np.zeros((1, 100, 2, 16), np.float32)
    with pytest.raises(ValueError, match="non-causal"):
        j_flash(jnp.asarray(q), jnp.asarray(q), jnp.asarray(q),
                causal=False)
    with pytest.raises(ValueError, match="non-causal"):
        flash_attention(T(q), T(q), T(q), causal=False)


def test_flash_keeps_input_dtype():
    rng = np.random.default_rng(3)
    q = T(rng.standard_normal((1, 32, 2, 16)).astype(np.float32))
    out = flash_attention(q.bfloat16(), q.bfloat16(), q.bfloat16())
    assert out.dtype == torch.bfloat16
    ref = flash_attention(q.bfloat16().float(), q.bfloat16().float(),
                          q.bfloat16().float())
    _close(out.float(), ref.bfloat16().float())


# ---------------------------------------------------------------------------
# ssd_scan
# ---------------------------------------------------------------------------


def _ssd_inputs(rng, bsz, L, H, P, N):
    """B and C group-shared, (bsz, L, N), as ssm_apply passes them."""
    log_a = -np.abs(rng.standard_normal((bsz, L, H))).astype(
        np.float32) * 0.2
    x = rng.standard_normal((bsz, L, H, P)).astype(np.float32)
    b = (rng.standard_normal((bsz, L, N)) * 0.3).astype(np.float32)
    c = (rng.standard_normal((bsz, L, N)) * 0.3).astype(np.float32)
    return log_a, x, b, c


@pytest.mark.parametrize("bsz,L,H,P,N,chunk", [
    (1, 64, 2, 16, 8, 16),
    (2, 100, 3, 16, 8, 32),    # ragged last chunk
    (1, 32, 1, 64, 16, 32),
])
def test_ssd_plain_matches_reference_kernel(bsz, L, H, P, N, chunk):
    """The reference's wrapper takes B and C per head: they are broadcast
    on its side alone, as its ssm_apply does."""
    rng = np.random.default_rng(L + P)
    args = _ssd_inputs(rng, bsz, L, H, P, N)
    log_a, x, b, c = map(jnp.asarray, args)
    ref = j_ssd(log_a, x, *(jnp.broadcast_to(m[:, :, None], (bsz, L, H, N))
                            for m in (b, c)), chunk=chunk)
    kernels.reset_launch_counts()
    out = ssd_scan(*map(T, args), chunk=chunk)
    assert kernels.launch_counts()["ssd_scan"] == 0   # CPU: plain
    _close(out, ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("bsz,L,H,P,N,chunk", [
    (1, 64, 2, 16, 8, 16), (2, 100, 3, 16, 8, 32), (2, 37, 4, 8, 16, 128)])
def test_ssd_plain_matches_port_chunked(bsz, L, H, P, N, chunk):
    """The step recurrence against the port's chunked form."""
    rng = np.random.default_rng(L * H)
    args = list(map(T, _ssd_inputs(rng, bsz, L, H, P, N)))
    out = ssd_scan(*args, chunk=chunk)
    chunked, _ = ssm._ssd_chunked(*args, chunk)
    _close(out, chunked, rtol=2e-4, atol=2e-4)


def test_ssd_refuses_mismatched_shapes():
    x = torch.zeros((1, 8, 2, 4))
    with pytest.raises(ValueError, match="ssd_scan"):
        ssd_scan(torch.zeros((1, 8, 2)), x, torch.zeros((1, 8, 3)),
                 torch.zeros((1, 8, 2)))
    per_head = torch.zeros((1, 8, 2, 3))      # B and C are group-shared
    with pytest.raises(ValueError, match="ssd_scan"):
        ssd_scan(torch.zeros((1, 8, 2)), x, per_head, per_head)


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


def test_rmsnorm_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32) * 3
    scale = rng.standard_normal(48).astype(np.float32)
    ref = j_common.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x))
    _close(common.rmsnorm({"scale": T(scale)}, T(x)), ref)


def test_rmsnorm_keeps_input_dtype():
    x = torch.randn(3, 16, generator=torch.Generator().manual_seed(0))
    out = common.rmsnorm({"scale": torch.ones(16)}, x.bfloat16())
    assert out.dtype == torch.bfloat16


def test_apply_rope_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 32)).astype(np.float32)
    pos = rng.integers(0, 4000, (2, 7)).astype(np.int32)
    ref = j_common.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0)
    _close(common.apply_rope(T(x), T(pos), 10_000.0), ref, atol=1e-5)


def test_apply_rope_refuses_mrope():
    """M-RoPE is ported (tests/test_torch_mla_vlm.py); what the reference
    asserts against is refused: (B, S) positions, or sections that do not
    split D/2."""
    with pytest.raises(ValueError, match="M-RoPE"):
        common.apply_rope(torch.zeros(1, 2, 1, 8),
                          torch.zeros(1, 2, dtype=torch.int32), 1e4,
                          (1, 1, 2))
    with pytest.raises(ValueError, match="M-RoPE"):
        common.apply_rope(torch.zeros(1, 2, 1, 8),
                          torch.zeros(1, 3, 2, dtype=torch.int32), 1e4,
                          (1, 1, 1))


def test_softplus_is_jax_softplus():
    x = np.linspace(-60, 60, 2001).astype(np.float32)
    _close(common.softplus(T(x)), jax.nn.softplus(jnp.asarray(x)))


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    rng = np.random.default_rng(2)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    x = rng.standard_normal((2, 9, 24)).astype(np.float32)
    st = rng.standard_normal((2, 3, 24)).astype(np.float32)
    state = st if with_state else None
    ref, ref_st = j_ssm._causal_conv(
        jnp.asarray(w), jnp.asarray(b), jnp.asarray(x),
        None if state is None else jnp.asarray(state))
    out, out_st = ssm._causal_conv(T(w), T(b), T(x),
                                   None if state is None else T(state))
    _close(out, ref)
    _close(out_st, ref_st)


@pytest.mark.parametrize("kw", [
    dict(), dict(window=5), dict(softcap=3.0), dict(causal=False),
    dict(window=6, softcap=2.0, chunk=4)])
def test_chunked_attention_matches_reference(kw):
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 13, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 13, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 13, 2, 16)).astype(np.float32)
    kw = dict(dict(chunk=8), **kw)
    ref = j_attn.chunked_attention(*map(jnp.asarray, (q, k, v)), **kw)
    _close(attention.chunked_attention(T(q), T(k), T(v), **kw), ref)


@pytest.mark.parametrize("variant", ["dynamic", "cnn"])
@pytest.mark.parametrize("where", ["random", "last"])
def test_cache_update_matches_reference(variant, where):
    rng = np.random.default_rng(5)
    b, s, h, d = 3, 12, 2, 4
    cache = rng.standard_normal((b, s, h, d)).astype(np.float32)
    new = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    lengths = (rng.integers(0, s, (b,)) if where == "random"
               else np.full((b,), s - 1)).astype(np.int32)
    ref = j_attn.cache_update(jnp.asarray(cache), jnp.asarray(new),
                              jnp.asarray(lengths), JVariant(variant))
    out = attention.cache_update(T(cache.copy()), T(new), T(lengths),
                                 Variant(variant))
    _close(out, ref, rtol=0, atol=0)


@pytest.mark.parametrize("kw", [dict(), dict(window=4), dict(softcap=2.5)])
def test_decode_attention_matches_reference(kw):
    rng = np.random.default_rng(6)
    q = rng.standard_normal((3, 1, 4, 16)).astype(np.float32)
    kc = rng.standard_normal((3, 10, 2, 16)).astype(np.float32)
    vc = rng.standard_normal((3, 10, 2, 16)).astype(np.float32)
    lengths = np.array([0, 5, 9], np.int32)
    ref = j_attn.decode_attention(*map(jnp.asarray, (q, kc, vc, lengths)),
                                  **kw)
    _close(attention.decode_attention(T(q), T(kc), T(vc), T(lengths), **kw),
           ref)
