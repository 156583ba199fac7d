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
from repro_torch.core import config as tcfg  # noqa: E402
from repro_torch.core import delays as tdelays  # noqa: E402
from repro_torch.kernels.bsr_spmm import (block_sample_axis,  # noqa: E402
                                          bsr_beamform, bsr_beamform_ref,
                                          bsr_spmm, bsr_spmm_ref, kept_slots,
                                          real_form)
from repro_torch.kernels.bsr_spmm import ops as bsr_ops  # noqa: E402


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
    (2, 2, 80, 24, 3, 5),     # bp past a 64-row tile, bs not a multiple of 8
    (2, 2, 128, 128, 3, 4),   # bs 128 with bp 128: bs staged in chunks
    (3, 8, 16, 16, 3, 6),     # K 8 over 3 sample blocks: repeated columns
    (2, 2, 16, 16, 4, 7),     # nf 7: no 16-byte copies of x
    (2, 2, 16, 16, 4, 130),   # nf past one 128-column tile
])
def test_bsr_spmm_ref_matches_reference_kernel(n_pb, k, bp, bs, n_sb, nf):
    args = _spmm_inputs(n_pb * bs, n_pb, k, bp, bs, n_sb, nf)
    if k == 8:          # the columns repeat and descend within a row
        cols = args[0]
        assert (np.diff(cols, axis=1) == 0).any()
        assert (np.diff(cols, axis=1) < 0).any()
    out = bsr_spmm_ref(*map(torch.as_tensor, args))
    _close(out, j_spmm(*map(jnp.asarray, args)))


def test_bsr_spmm_sums_every_slot_of_a_padded_row():
    """Every stored slot is summed, whatever its column: a NaN in x at
    column 0, where a row's padding (all-zero) blocks point, reaches that
    row's output, in the reference kernel and in the plain version the
    card's kernel is held to."""
    cols, blocks, x = _spmm_inputs(2, 3, 3, 16, 16, 4, 5)
    cols[1] = [2, 0, 0]                  # one occupied slot, then padding
    blocks[1, 1:] = 0.0
    cols[[0, 2]] = np.maximum(cols[[0, 2]], 1)   # rows 0, 2 skip column 0
    x[0, 3, 2] = np.nan
    out = bsr_spmm_ref(*map(torch.as_tensor, (cols, blocks, x))).numpy()
    ref = np.asarray(j_spmm(*map(jnp.asarray, (cols, blocks, x))))
    for y in (out, ref):
        assert np.isnan(y[1, :, 2]).all()
        assert np.isfinite(np.delete(y, 1, axis=0)).all()
        assert np.isfinite(y[1][:, [0, 1, 3, 4]]).all()


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


# The geometries of the skip-rule tests: the tiny config, a wider one at
# 16 x 16 blocks (some (channel, pixel block) rows hold no occupied block),
# and a mid one at the paper's 64 x 64 blocks.
SKIP_GEOMS = {"tiny": {}, "wide": dict(n_c=16, n_f=8, nz=32, nx=32),
              "mid": dict(n_c=16, nz=64, nx=32, sparse_block_p=64,
                          sparse_block_s=64)}


def _nonzero_blocks(blocks):
    """(n_c, n_pb, K) bool: blocks with any non-zero value."""
    return (np.asarray(blocks) != 0).reshape(blocks.shape[:3] + (-1,)).any(-1)


@pytest.mark.parametrize("geom", sorted(SKIP_GEOMS))
def test_reference_operator_pads_after_ascending_columns(geom):
    """The format the kernel's skip rule reads, on the reference's
    operator: the occupied (non-zero) slots of each row come first with
    strictly ascending columns; every slot after them is an all-zero block
    at column 0. So the slots ``kept_slots`` leaves out are all-zero
    blocks, and the only all-zero blocks it keeps are slot 0 of rows with
    no occupied slot."""
    cfg = jcfg.tiny_config(variant="sparse", **SKIP_GEOMS[geom])
    op = bsr_operator(cfg, compute_delay_tables(cfg))
    nonzero = _nonzero_blocks(op.blocks)
    n_occ = nonzero.sum(-1)                                  # per row
    k = np.arange(op.col_idx.shape[-1])
    assert np.array_equal(nonzero, k < n_occ[..., None])     # occupied first
    cols = op.col_idx
    ascending = cols[..., 1:] > cols[..., :-1]
    assert ascending[nonzero[..., 1:]].all()
    assert (cols[~nonzero] == 0).all()
    kept = kept_slots(torch.as_tensor(cols)).numpy()
    assert not nonzero[~kept].any()                # every skipped slot zero
    empty_row_slot0 = (n_occ == 0)[..., None] & (k == 0)
    assert np.array_equal(kept & ~nonzero, empty_row_slot0)
    if geom != "wide":                             # no empty rows there
        assert not empty_row_slot0.any()
        assert np.array_equal(kept, nonzero)


@pytest.mark.parametrize("package", ["reference", "port"])
def test_kept_slots_matches_nonzero_blocks(package):
    """``kept_slots`` against ``(blocks != 0).any(...)`` on both packages'
    operators (bit for bit the same): kept = non-zero, plus slot 0 of the
    rows with no non-zero block."""
    geom = SKIP_GEOMS["wide"]
    if package == "reference":
        cfg = jcfg.tiny_config(variant="sparse", **geom)
        op = bsr_operator(cfg, compute_delay_tables(cfg))
    else:
        cfg = tcfg.tiny_config(variant="sparse", **geom)
        op = tdelays.bsr_operator(cfg, tdelays.compute_delay_tables(cfg))
    nonzero = _nonzero_blocks(op.blocks)
    kept = kept_slots(torch.as_tensor(op.col_idx)).numpy()
    empty = ~nonzero.any(-1, keepdims=True)
    slot0 = np.arange(nonzero.shape[-1]) == 0
    assert empty.any()
    assert np.array_equal(kept, nonzero | (empty & slot0))


def test_kept_slots_rule_on_edge_rows():
    """A real block at column 0 in slot 0, an empty row, a full row, and
    a row with one occupied slot followed by padding."""
    cols = torch.tensor([[0, 0, 0], [0, 0, 0], [1, 3, 4], [2, 0, 0],
                         [0, 5, 0]], dtype=torch.int32)
    want = torch.tensor([[1, 0, 0], [1, 0, 0], [1, 1, 1], [1, 0, 0],
                         [1, 1, 0]], dtype=torch.bool)
    assert torch.equal(kept_slots(cols), want)
    assert torch.equal(kept_slots(cols[None]), want[None])


def _tiny_operator():
    cfg = tcfg.tiny_config(variant="sparse", **SKIP_GEOMS["wide"])
    return tdelays.bsr_operator(cfg, tdelays.compute_delay_tables(cfg))


def test_operator_check_passes_the_built_operator():
    """``bsr_operator`` runs ``check_skipped_slots`` on what it builds;
    the tiny config's operator has skipped slots, and passes."""
    op = _tiny_operator()
    assert not kept_slots(torch.as_tensor(op.col_idx)).all()
    tdelays.check_skipped_slots(op.col_idx, op.blocks)


@pytest.mark.parametrize("where", ["first", "last"])
def test_operator_check_refuses_a_value_in_a_skipped_slot(where):
    """One non-zero value in a slot the kernel skips: the CPU path would
    add it and the kernel drop it, so the check raises."""
    op = _tiny_operator()
    skipped = np.argwhere(~kept_slots(torch.as_tensor(op.col_idx)).numpy())
    c, pb, k = skipped[0 if where == "first" else -1]
    blocks = op.blocks.copy()
    blocks[c, pb, k, 0, 0, 1] = 1e-3
    with pytest.raises(ValueError, match=f"channel {c} holds 1 non-zero"):
        tdelays.check_skipped_slots(op.col_idx, blocks)


@pytest.mark.parametrize("where", ["first", "last"])
def test_operator_check_on_tensors_refuses_a_value_in_a_skipped_slot(where):
    """The same check on torch tensors, as the wrapper runs it on the
    card: the built operator passes, one value in a skipped slot (the
    first or the last such slot) raises, naming its channel."""
    op = _tiny_operator()
    cols, blocks = torch.as_tensor(op.col_idx), torch.as_tensor(op.blocks)
    tdelays.check_skipped_slots(cols, blocks)
    skipped = torch.nonzero(~kept_slots(cols))
    c, pb, k = skipped[0 if where == "first" else -1].tolist()
    bad = blocks.clone()
    bad[c, pb, k, -1, -1, 0] = -2.5
    with pytest.raises(ValueError, match=f"channel {c} holds 1 non-zero"):
        tdelays.check_skipped_slots(cols, bad)


def test_wrapper_check_is_remembered_per_operator(monkeypatch):
    """``require_checked`` (what ``bsr_beamform`` runs on CUDA tensors
    before a launch) checks an operator once; the same tensors again
    cost nothing; an in-place change (a new ``_version``) is checked anew
    and refused; an unchecked operator under a CUDA graph capture raises
    before anything is read back."""
    calls = []
    real_check = tdelays.check_skipped_slots

    def counting(cols, blocks):
        calls.append(1)
        real_check(cols, blocks)

    op = _tiny_operator()
    monkeypatch.setattr(tdelays, "check_skipped_slots", counting)
    cols, blocks = torch.as_tensor(op.col_idx), torch.tensor(op.blocks)
    bsr_ops.require_checked(cols, blocks)
    bsr_ops.require_checked(cols, blocks)
    assert len(calls) == 1
    c, pb, k = torch.nonzero(~kept_slots(cols))[0].tolist()
    blocks[c, pb, k, 0, 0, 0] = 1.0               # bumps blocks._version
    with pytest.raises(ValueError, match=f"channel {c} holds 1 non-zero"):
        bsr_ops.require_checked(cols, blocks)
    assert len(calls) == 2
    fresh = blocks.clone()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(RuntimeError, match="capture unchecked"):
        bsr_ops.require_checked(cols, fresh)
    assert len(calls) == 2
    fresh[c, pb, k] = 0.0
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    bsr_ops.require_checked(cols, fresh)          # checked, then remembered
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    bsr_ops.require_checked(cols, fresh)
    assert len(calls) == 3
    del fresh                                     # its entry goes with it
    assert all(r[1]() is not None for r in bsr_ops._CHECKED.values())


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_real_form_product_equals_the_complex_beamform(precision):
    """The sparse beamform written as one real BSR product (``real_form``,
    which chip_smoke.py times the real kernel on): the plain real product,
    viewed back, equals the plain complex beamform and the reference's
    ``bsr_beamform`` on the tiny sparse operator (rtol 1e-5, atol 1e-5 *
    max: the same products summed in another order)."""
    op = _tiny_operator()
    n_c, _, _, _, bs, _ = op.blocks.shape
    rng = np.random.default_rng(9)
    n_sb, n_f = int(op.col_idx.max()) + 2, 3
    iq_b = rng.standard_normal((2, n_sb, bs, n_c, n_f, 2)).astype(np.float32)
    cols, blocks = torch.as_tensor(op.col_idx), torch.as_tensor(op.blocks)
    args, back = real_form(cols, blocks, torch.as_tensor(iq_b))
    n_pb = cols.shape[1]
    assert args[0].dtype == torch.int32
    assert args[1].shape == (n_pb, n_c * cols.shape[2], 2 * op.bp, 2 * bs)
    assert args[2].shape == (n_c * n_sb, 2 * bs, 2 * n_f)
    out = back(bsr_spmm_ref(*args, precision=precision))
    want = bsr_beamform_ref(cols, blocks, torch.as_tensor(iq_b),
                            precision=precision)
    _close(out, want)
    for b in range(iq_b.shape[0]):
        _close(out[b], j_beamform(jnp.asarray(op.col_idx),
                                  jnp.asarray(op.blocks),
                                  jnp.asarray(iq_b[b]), precision=precision))
