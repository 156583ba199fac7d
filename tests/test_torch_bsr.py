"""The BSR SpMM kernel module of the PyTorch port on the CPU.

The plain versions (``bsr_spmm_ref``, ``bsr_beamform_ref``) are held to
the reference's Pallas kernels run in interpret mode on the same seeded
numpy inputs: rtol 1e-5, atol 1e-5 * max|ref| (sums run in another
order: over channels, K slots and samples). At bf16/f16 both round the
same operands and sum in f32, so they agree to that same tolerance. The
CUDA kernels are held to these plain versions on the card
(tests/test_torch_gpu.py, chip_smoke.py).
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import config as jcfg  # noqa: E402
from repro.core.delays import bsr_operator, compute_delay_tables  # noqa: E402
from repro.kernels.bsr_spmm import bsr_beamform as j_beamform  # noqa: E402
from repro.kernels.bsr_spmm import bsr_spmm as j_spmm  # noqa: E402
from repro.kernels.pallas_compat import (  # noqa: E402
    block_sample_axis as j_block_sample_axis)

from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.bsr_spmm import (block_sample_axis,  # noqa: E402
                                          bsr_beamform, bsr_beamform_ref,
                                          bsr_spmm, bsr_spmm_ref)


def _close(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


def _spmm_inputs(seed, n_pb, k, bp, bs, n_sb, nf):
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, n_sb, (n_pb, k)).astype(np.int32)
    blocks = rng.standard_normal((n_pb, k, bp, bs)).astype(np.float32)
    x = rng.standard_normal((n_sb, bs, nf)).astype(np.float32)
    return cols, blocks, x


@pytest.mark.parametrize("n_pb,k,bp,bs,n_sb,nf", [
    (4, 2, 16, 16, 6, 3),
    (8, 1, 8, 32, 4, 8),      # K = 1
    (3, 3, 32, 8, 9, 1),      # nf = 1, more sample blocks than pixel blocks
    (5, 2, 16, 16, 7, 40),    # more columns than the kernel's 32-wide tile
    (2, 2, 80, 24, 3, 5),     # bp past the kernel's 64-row tile
])
def test_bsr_spmm_ref_matches_reference_kernel(n_pb, k, bp, bs, n_sb, nf):
    args = _spmm_inputs(n_pb * bs, n_pb, k, bp, bs, n_sb, nf)
    out = bsr_spmm_ref(*map(torch.as_tensor, args))
    _close(out, j_spmm(*map(jnp.asarray, args)))


@pytest.mark.parametrize("precision", ["bf16", "f16"])
def test_bsr_spmm_ref_reduced_precision_matches_reference_kernel(precision):
    args = _spmm_inputs(1, 4, 2, 16, 16, 6, 3)
    out = bsr_spmm_ref(*map(torch.as_tensor, args), precision=precision)
    _close(out, j_spmm(*map(jnp.asarray, args), precision=precision))
    assert not torch.equal(out, bsr_spmm_ref(*map(torch.as_tensor, args)))


GEOMS = {"tiny": {}, "wide": dict(n_c=16, n_f=8, nz=32, nx=32)}


@pytest.fixture(scope="module", params=sorted(GEOMS))
def operator(request):
    """The reference's BSR operator on real delay tables, and seeded
    blocked IQ for two acquisitions."""
    cfg = jcfg.tiny_config(**GEOMS[request.param])
    op = bsr_operator(cfg, compute_delay_tables(cfg))
    rng = np.random.default_rng(3)
    iq = rng.standard_normal((2, cfg.n_s, cfg.n_c, cfg.n_f, 2))
    iq_b = np.stack([np.asarray(j_block_sample_axis(jnp.asarray(a), op.bs))
                     for a in iq.astype(np.float32)])
    return cfg, op, iq.astype(np.float32), iq_b


def test_block_sample_axis_matches_reference(operator):
    cfg, op, iq, iq_b = operator
    out = block_sample_axis(torch.as_tensor(iq), op.bs)
    assert np.array_equal(out.numpy(), iq_b)
    same = block_sample_axis(torch.as_tensor(iq[:, :2 * op.bs]), op.bs)
    assert same.shape[1:3] == (2, op.bs)        # no padding when it fits


@pytest.mark.parametrize("precision", ["f32", "bf16", "f16"])
def test_bsr_beamform_ref_matches_reference_kernel(operator, precision):
    cfg, op, _, iq_b = operator
    out = bsr_beamform_ref(torch.as_tensor(op.col_idx),
                           torch.as_tensor(op.blocks),
                           torch.as_tensor(iq_b), precision=precision)
    for b in range(iq_b.shape[0]):
        ref = j_beamform(jnp.asarray(op.col_idx), jnp.asarray(op.blocks),
                         jnp.asarray(iq_b[b]), precision=precision)
        _close(out[b], ref)


def test_wrappers_route_cpu_tensors_to_plain_version(operator):
    _, op, _, iq_b = operator
    cols, blocks = torch.as_tensor(op.col_idx), torch.as_tensor(op.blocks)
    x = torch.as_tensor(iq_b)
    kernels.reset_launch_counts()
    for p in ("f32", "bf16"):
        assert torch.equal(bsr_beamform(cols, blocks, x, precision=p),
                           bsr_beamform_ref(cols, blocks, x, precision=p))
    args = [torch.as_tensor(a) for a in _spmm_inputs(0, 4, 2, 16, 16, 6, 3)]
    assert torch.equal(bsr_spmm(*args), bsr_spmm_ref(*args))
    assert set(kernels.launch_counts().values()) == {0}


def test_wrappers_refuse_bad_arguments():
    cols, blocks, x = map(torch.as_tensor, _spmm_inputs(0, 2, 1, 8, 8, 2, 2))
    with pytest.raises(ValueError, match="precision"):
        bsr_spmm(cols, blocks, x, precision="fp8")
    with pytest.raises(ValueError, match="cuda or cpu"):
        bsr_spmm(cols, blocks, x.to("meta"))
    with pytest.raises(ValueError, match="precision"):
        bsr_beamform(cols[None], blocks[None, ..., None], x, precision="x")
