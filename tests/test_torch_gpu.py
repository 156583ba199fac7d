"""The port's CUDA kernels against their plain PyTorch versions, on the card.

A CUDA kernel has no CPU mode, so every test here is marked ``gpu`` and
skips where there is no CUDA device. On a machine with one:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest``: tests/conftest.py imports JAX, which that machine
need not have; nothing here uses its fixtures.)

Tolerance: 1e-5 * max|plain| at every precision. Kernel and plain
version round each per-channel term alike (the kernels are built with
-fmad=false and the same operand casts); only the order of the channel
sum differs, which a CPU emulation at the paper's geometry puts at
3.4e-7 of the maximum. The BSR kernels round the same operands as their
plain versions and sum in f32 with fused multiply-adds, in another order.

The LM kernels are held to their plain versions with the CPU parity
tolerances of tests/test_torch_lm_kernels.py: flash attention rtol 2e-4,
atol 2e-5 (online softmax in tiles against one softmax), the SSD scan
rtol = atol = 2e-4 (chunked against the step recurrence). From bf16
inputs both compute in f32 and round once to bf16, so they agree within
one bf16 step (rtol 2**-7).
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from repro_torch import kernels  # noqa: E402
from repro_torch.core import (BatchedExecutor, consts_from_numpy,  # noqa: E402
                              init_pipeline, monolithic_pipeline_fn,
                              paper_config, tiny_config)
from repro_torch.core.cnn_ops import sqrt_rn  # noqa: E402
from repro_torch.data import synth_rf  # noqa: E402
from repro_torch.kernels.bsr_spmm import (block_sample_axis,  # noqa: E402
                                          bsr_beamform, bsr_beamform_ref,
                                          bsr_spmm, bsr_spmm_ref)
from repro_torch.kernels.das_beamform import (das_beamform,  # noqa: E402
                                              das_beamform_ref)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_ref)
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.fused_pipeline import (  # noqa: E402
    fused_ref, fused_rf_to_envelope, fused_rf_to_power)
from repro_torch.kernels.fused_pipeline.ref import demod_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_ref  # noqa: E402

pytestmark = pytest.mark.gpu

TABLES = ("carrier", "lpf", "idx", "frac", "apod", "rot")
DAS_TABLES = ("idx", "frac", "apod", "rot")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _close(out, ref):
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    assert err <= 1e-5 * ref.abs().max().item(), err


@pytest.mark.parametrize("precision", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("n_pix,n_c,n_s,n_f", [
    (64, 4, 32, 2), (100, 3, 40, 1), (40, 5, 24, 33), (333, 16, 128, 32)])
def test_das_kernel_matches_plain(cuda, precision, n_pix, n_c, n_s, n_f):
    g = torch.Generator().manual_seed(n_pix)
    idx = torch.randint(0, n_s - 1, (n_pix, n_c), generator=g,
                        dtype=torch.int32)
    frac = torch.rand(n_pix, n_c, generator=g)
    apod = torch.rand(n_pix, n_c, generator=g)
    ph = torch.rand(n_pix, n_c, generator=g) * 6.28
    rot = torch.stack([ph.cos(), ph.sin()], -1)
    iq = torch.randn(3, n_s, n_c, n_f, 2, generator=g)
    args = [t.to(cuda) for t in (idx, frac, apod, rot, iq)]
    before = das_beamform.launches
    out = das_beamform(*args, precision=precision)
    assert das_beamform.launches == before + 1
    _close(out, das_beamform_ref(*args, precision=precision))


@pytest.mark.parametrize("precision", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("kw", [{}, dict(n_c=16, n_f=8, nz=32, nx=32)])
def test_fused_kernels_match_plain(cuda, kw, precision):
    cfg = tiny_config(variant="dynamic", modality="power_doppler", **kw)
    c = consts_from_numpy(init_pipeline(cfg), cuda)
    rf = torch.as_tensor(np.stack([synth_rf(cfg, seed=s)
                                   for s in (1, 2)])).to(cuda)
    tabs = [c[k] for k in TABLES]
    p = dict(decim=cfg.decim, precision=precision)
    _close(fused_rf_to_envelope(*tabs, rf, **p), fused_ref(*tabs, rf, **p))
    _close(fused_rf_to_power(*tabs, c["wall_taps"], rf, **p),
           fused_ref(*tabs, rf, head="power_doppler", wall=c["wall_taps"],
                     **p))


@pytest.fixture(scope="module")
def paper():
    """The paper's geometry on the card: its delay tables (real windows,
    37 % of (pixel, channel) pairs of zero apodization), carrier, taps
    and wall filter, two seeded RF acquisitions and their IQ."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    cfg = paper_config(variant="dynamic", modality="power_doppler")
    c = consts_from_numpy(init_pipeline(cfg), dev)
    rf = torch.as_tensor(np.stack([synth_rf(cfg, seed=s)
                                   for s in (1, 2)])).to(dev)
    iq = demod_ref(c["carrier"], c["lpf"], rf, cfg.decim)
    return cfg, c, rf, iq


def _fused_pair(cfg, c, rf, n_pix=None, **kw):
    """(kernel, plain) envelope and R0 on the first n_pix pixels."""
    tabs = [c[k][:n_pix] if k in DAS_TABLES else c[k] for k in TABLES]
    p = dict(decim=cfg.decim, **kw)
    q = {k: v for k, v in p.items() if k != "bp"}
    return ((fused_rf_to_envelope(*tabs, rf, **p), fused_ref(*tabs, rf, **q)),
            (fused_rf_to_power(*tabs, c["wall_taps"], rf, **p),
             fused_ref(*tabs, rf, head="power_doppler", wall=c["wall_taps"],
                       **q)))


@pytest.mark.parametrize("precision", ["f32", "bf16", "f16"])
def test_das_kernel_on_paper_tables(paper, precision):
    cfg, c, _, iq = paper
    tabs = [c[k] for k in DAS_TABLES]
    assert (c["apod"] == 0).float().mean().item() > 0.3
    _close(das_beamform(*tabs, iq, precision=precision),
           das_beamform_ref(*tabs, iq, precision=precision))


@pytest.mark.parametrize("precision", ["f32", "bf16", "f16"])
def test_fused_kernels_on_paper_tables(paper, precision):
    cfg, c, rf, _ = paper
    for out, ref in _fused_pair(cfg, c, rf, precision=precision):
        _close(out, ref)


@pytest.mark.parametrize("bp", [64, 128, 256])
def test_fused_kernels_at_each_tile_on_a_ragged_pixel_count(paper, bp):
    """Each pixel tile against the plain version, on the paper's tables cut
    to 16,336 pixels: no multiple of 64, so every tile size ends ragged."""
    cfg, c, rf, _ = paper
    kernels.reset_launch_counts()
    for out, ref in _fused_pair(cfg, c, rf, n_pix=16336, bp=bp):
        _close(out, ref)
    counts = kernels.launch_counts()
    assert counts["fused_rf_to_envelope"] == counts["fused_rf_to_power"] == 1


def test_kernels_are_bit_identical_run_to_run(paper):
    cfg, c, rf, iq = paper
    tabs = [c[k] for k in DAS_TABLES]
    for prec in ("f32", "bf16"):
        assert torch.equal(das_beamform(*tabs, iq, precision=prec),
                           das_beamform(*tabs, iq, precision=prec))
        first = _fused_pair(cfg, c, rf, precision=prec)
        second = _fused_pair(cfg, c, rf, precision=prec)
        for (a, _), (b, _) in zip(first, second):
            assert torch.equal(a, b)


def test_das_library_reports_its_tile_and_scratch(cuda):
    """The constants that counts made outside the libraries read from them:
    the DAS tile (each thread holds 32 complex sums: bp / 8 pixels x
    block_acqs acquisitions) and the power head's scratch, none up to one
    warp's 32 frames, the beamformed samples past them."""
    import ctypes

    from repro_torch.kernels import cuda_lib
    from repro_torch.kernels.das_beamform.ops import tile_plan
    plan = tile_plan()
    assert plan["bp"] in (64, 128, 256)
    assert plan["bp"] // 8 * plan["block_acqs"] == 32
    assert plan["stage_rows"] > 0
    scratch = cuda_lib.kernel_fn(
        "fused_pipeline", "fused_power_scratch_floats", [ctypes.c_int] * 3,
        restype=ctypes.c_longlong)
    assert scratch(4, 100, 32) == 0
    assert scratch(4, 100, 33) == 2 * 4 * 100 * 33


@pytest.mark.parametrize("bp", [64, 256])
@pytest.mark.parametrize("n_f", [1, 33])
def test_fused_kernels_on_wide_windows(cuda, n_f, bp):
    """Random delays over all of n_s (windows wider than the stage: the
    loop's path from global memory), a quarter of zero apodization, and
    n_f of 1 and 33 (past one warp's frames: the power head's scratch)."""
    cfg = tiny_config(variant="dynamic", n_c=8, n_f=n_f, nz=24, nx=13)
    c = consts_from_numpy(init_pipeline(cfg), cuda)
    g = torch.Generator().manual_seed(n_f)
    n_pix = cfg.n_pix
    c["idx"] = torch.randint(0, cfg.n_s - 1, (n_pix, cfg.n_c), generator=g,
                             dtype=torch.int32).to(cuda)
    c["frac"] = torch.rand(n_pix, cfg.n_c, generator=g).to(cuda)
    apod = torch.rand(n_pix, cfg.n_c, generator=g)
    c["apod"] = torch.where(apod < 0.25, 0.0, apod).to(cuda)
    c["wall_taps"] = torch.tensor([0.5, -1.0, 0.5][:n_f], device=cuda)
    rf = torch.randint(-2000, 2000, (3, cfg.n_l, cfg.n_c, n_f), generator=g,
                       dtype=torch.int16).to(cuda)
    for out, ref in _fused_pair(cfg, c, rf, bp=bp):
        _close(out, ref)


@pytest.mark.parametrize("precision", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("n_pb,k,bp,bs,n_sb,nf", [
    (4, 2, 16, 16, 6, 3), (8, 1, 8, 32, 4, 8), (3, 3, 32, 8, 9, 1),
    (5, 2, 16, 16, 7, 40), (2, 2, 80, 24, 3, 5), (16, 2, 64, 64, 6, 128)])
def test_bsr_spmm_kernel_matches_plain(cuda, precision, n_pb, k, bp, bs,
                                       n_sb, nf):
    g = torch.Generator().manual_seed(n_pb * bs)
    cols = torch.randint(0, n_sb, (n_pb, k), generator=g, dtype=torch.int32)
    blocks = torch.randn(n_pb, k, bp, bs, generator=g)
    x = torch.randn(n_sb, bs, nf, generator=g)
    args = [t.to(cuda) for t in (cols, blocks, x)]
    before = bsr_spmm.launches
    out = bsr_spmm(*args, precision=precision)
    assert bsr_spmm.launches == before + 1
    _close(out, bsr_spmm_ref(*args, precision=precision))


@pytest.mark.parametrize("precision", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("kw", [{}, dict(n_c=16, n_f=8, nz=32, nx=32),
                                dict(n_c=16, n_f=40, nz=64, nx=32,
                                     sparse_block_p=64, sparse_block_s=64)])
def test_bsr_beamform_kernel_matches_plain(cuda, kw, precision):
    cfg = tiny_config(variant="sparse", **kw)
    c = consts_from_numpy(init_pipeline(cfg), cuda)
    g = torch.Generator().manual_seed(cfg.n_c)
    iq = torch.randn(3, cfg.n_s, cfg.n_c, cfg.n_f, 2, generator=g)
    iq_b = block_sample_axis(iq.to(cuda), cfg.sparse_block_s)
    args = (c["bsr_col_idx"], c["bsr_blocks"], iq_b)
    before = bsr_beamform.launches
    out = bsr_beamform(*args, precision=precision)
    assert bsr_beamform.launches == before + 1
    _close(out, bsr_beamform_ref(*args, precision=precision))


@pytest.mark.parametrize("n_pb,bp,bs", [(70000, 1, 8),
                                         (1, 64 * 65535 + 1, 1)])
def test_bsr_beamform_kernel_refuses_what_it_cannot_take(cuda, n_pb, bp, bs):
    """More pixel blocks than the grid's y axis holds, or more 64-row
    tiles of a pixel block than its z axis: the kernel refuses, the
    wrapper raises, and nothing is launched. (Samples are staged in
    chunks of 64, so no bs is past shared memory.)"""
    cols = torch.zeros((1, n_pb, 1), dtype=torch.int32, device=cuda)
    blocks = torch.ones((1, n_pb, 1, bp, bs, 2), device=cuda)
    iq_b = torch.ones((1, 1, bs, 1, 1, 2), device=cuda)
    before = bsr_beamform.launches
    with pytest.raises(RuntimeError, match="bsr_beamform_launch"):
        bsr_beamform(cols, blocks, iq_b)
    assert bsr_beamform.launches == before


def _edge_operator(cuda, n_c, n_pb, k, bp, bs, n_sb, seed):
    """A BSR operator in bsr_operator's format with the rows the skip rule
    must get right: row 0 of every channel holds one real block at column
    0 in slot 0 (then padding), row 1 is empty, row 2 has every K slot
    occupied, the rest a random count of random ascending columns."""
    rng = np.random.default_rng(seed)
    cols = np.zeros((n_c, n_pb, k), np.int32)
    n_occ = rng.integers(0, k + 1, (n_c, n_pb))
    n_occ[:, 0], n_occ[:, 1], n_occ[:, 2] = 1, 0, k
    for c in range(n_c):
        for i in range(n_pb):
            cols[c, i, :n_occ[c, i]] = np.sort(
                rng.choice(n_sb, n_occ[c, i], replace=False))
    cols[:, 0, 0] = 0
    blocks = rng.standard_normal((n_c, n_pb, k, bp, bs, 2)).astype(
        np.float32)
    blocks[np.arange(k) >= n_occ[..., None]] = 0.0
    return (torch.as_tensor(cols).to(cuda), torch.as_tensor(blocks).to(cuda))


# (B, n_c, n_pb, K, bp, bs, n_sb, n_f); where the output tiles are few the
# kernel splits the channels over up to 4 thread blocks and adds their
# partial tiles in order, elsewhere each tile is one block
EDGE_SHAPES = [
    (2, 3, 5, 3, 80, 24, 4, 5),       # ragged rows, odd n_f (8-byte copies)
    (2, 3, 4, 2, 48, 21, 5, 3),       # odd bs: 8-byte operator copies too
    (3, 4, 4, 2, 64, 64, 6, 40),      # two column tiles, a ragged one
    (1, 2, 3, 4, 16, 136, 5, 1),      # bs past one 64-sample chunk, n_f 1
    (4, 5, 3, 2, 64, 64, 6, 32),      # the paper's tile: 128 columns
    (2, 1, 6, 2, 64, 64, 3, 8),       # one channel: no channel groups
    (1, 2, 1100, 1, 8, 8, 2, 2),      # tiles enough: no channel groups
]


@pytest.mark.parametrize("precision", ["f32", "bf16", "f16"])
@pytest.mark.parametrize("shape", EDGE_SHAPES)
def test_bsr_beamform_kernel_on_edge_rows(cuda, shape, precision):
    b, n_c, n_pb, k, bp, bs, n_sb, n_f = shape
    cols, blocks = _edge_operator(cuda, n_c, n_pb, k, bp, bs, n_sb,
                                  seed=n_pb * bs)
    g = torch.Generator().manual_seed(bs)
    iq_b = torch.randn(b, n_sb, bs, n_c, n_f, 2, generator=g).to(cuda)
    before = bsr_beamform.launches
    out = bsr_beamform(cols, blocks, iq_b, precision=precision)
    assert bsr_beamform.launches == before + 1
    _close(out, bsr_beamform_ref(cols, blocks, iq_b, precision=precision))


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_bsr_beamform_kernel_is_bit_identical_run_to_run(cuda, precision):
    cfg = tiny_config(variant="sparse", n_c=16, n_f=32, nz=64, nx=32,
                      sparse_block_p=64, sparse_block_s=64)
    c = consts_from_numpy(init_pipeline(cfg), cuda)
    g = torch.Generator().manual_seed(5)
    iq = torch.randn(4, cfg.n_s, cfg.n_c, cfg.n_f, 2, generator=g)
    iq_b = block_sample_axis(iq.to(cuda), cfg.sparse_block_s)
    args = (c["bsr_col_idx"], c["bsr_blocks"], iq_b)
    first = bsr_beamform(*args, precision=precision)
    for _ in range(3):
        assert torch.equal(bsr_beamform(*args, precision=precision), first)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_bsr_beamform_rows_do_not_depend_on_the_batch(cuda, precision):
    """At the paper's 256 pixel blocks a batch of 5 spans two column
    tiles and a batch of 3 one: each acquisition's image is the same bit
    for bit in either (the channel groups are counted without the
    batch), so a sharded batch equals the whole one."""
    cfg = paper_config(variant="sparse")
    c = consts_from_numpy(init_pipeline(cfg), cuda)
    g = torch.Generator().manual_seed(6)
    iq = torch.randn(5, cfg.n_s, cfg.n_c, cfg.n_f, 2, generator=g)
    iq_b = block_sample_axis(iq.to(cuda), cfg.sparse_block_s)
    args = (c["bsr_col_idx"], c["bsr_blocks"])
    whole = bsr_beamform(*args, iq_b, precision=precision)
    for rows in (slice(0, 3), slice(3, 5), slice(2, 3)):
        part = bsr_beamform(*args, iq_b[rows].contiguous(),
                            precision=precision)
        assert torch.equal(part, whole[rows]), rows


def test_bsr_beamform_kernel_keeps_f32_error(cuda):
    """The f32 kernel (3xTF32, each staged unit summed from zero and added
    in f32) and the plain f32 version, each against the plain version in
    float64, on the real operator at 64 x 64 blocks: the kernel is held to
    1e-5 * max there and to at most twice the plain version's error (the
    split drops the lo x lo term, about 2^-22 of a product)."""
    cfg = tiny_config(variant="sparse", n_c=32, n_f=32, nz=64, nx=64,
                      sparse_block_p=64, sparse_block_s=64)
    c = consts_from_numpy(init_pipeline(cfg), cuda)
    g = torch.Generator().manual_seed(6)
    iq = torch.randn(4, cfg.n_s, cfg.n_c, cfg.n_f, 2, generator=g)
    iq_b = block_sample_axis(iq.to(cuda), cfg.sparse_block_s)
    cols, blocks = c["bsr_col_idx"], c["bsr_blocks"]
    exact = bsr_beamform_ref(cols, blocks.double(), iq_b.double())
    out = bsr_beamform(cols, blocks, iq_b).double()
    plain = bsr_beamform_ref(cols, blocks, iq_b).double()
    torch.cuda.synchronize()
    err, err_plain = ((t - exact).abs().max().item() for t in (out, plain))
    assert err <= 1e-5 * exact.abs().max().item(), err
    assert err <= 2 * err_plain, (err, err_plain)


@pytest.mark.parametrize("modality", ["bmode", "power_doppler", "doppler"])
@pytest.mark.parametrize("variant", ["cnn", "sparse"])
def test_operator_variant_on_card_matches_cpu(cuda, variant, modality):
    cfg = tiny_config(variant=variant, modality=modality, n_c=16, n_f=8,
                      nz=32, nx=32)
    rf = np.stack([synth_rf(cfg, seed=s) for s in (3, 4)])
    kernels.reset_launch_counts()
    out = BatchedExecutor(cfg).call_padded(rf, pad_to=4).cpu()
    ref = BatchedExecutor(cfg, device="cpu")(rf)
    counts = kernels.launch_counts()
    assert counts["bsr_beamform"] == (variant == "sparse"), counts
    d = (out - ref).abs()
    assert d.max().item() <= (1.2e-3 if modality == "bmode" else 1e-4)


@pytest.mark.parametrize("fusion", ["none", "fused"])
@pytest.mark.parametrize("modality", ["bmode", "power_doppler"])
def test_executor_on_card_matches_cpu(cuda, modality, fusion):
    cfg = tiny_config(variant="dynamic", modality=modality, fusion=fusion,
                      n_c=16, n_f=8, nz=32, nx=32)
    rf = np.stack([synth_rf(cfg, seed=s) for s in (3, 4)])
    kernels.reset_launch_counts()
    out = BatchedExecutor(cfg).call_padded(rf, pad_to=4).cpu()
    ref = BatchedExecutor(cfg, device="cpu")(rf)
    counts = kernels.launch_counts()
    key = {"none": "das_beamform", "fused": {
        "bmode": "fused_rf_to_envelope",
        "power_doppler": "fused_rf_to_power"}[modality]}[fusion]
    assert counts[key] == 1, counts
    d = (out - ref).abs()
    assert d.max().item() <= (1.2e-3 if modality == "bmode" else 1e-4)


def test_cuda_sqrt_is_correctly_rounded(cuda):
    x = torch.rand(1 << 20, dtype=torch.float64) * 1e4
    x = x.to(torch.float32)
    exact = torch.sqrt(x.double()).float()
    assert torch.equal(sqrt_rn(x.to(cuda)).cpu(), exact)


# ---------------------------------------------------------------------------
# LM kernels
# ---------------------------------------------------------------------------


def _qkv(cuda, b, l, hq, hkv, d, dtype=torch.float32):
    g = torch.Generator().manual_seed(b * l + d)
    return [torch.randn(b, l, h, d, generator=g).to(cuda, dtype)
            for h in (hq, hkv, hkv)]


@pytest.mark.parametrize("b,l,hq,hkv,d,causal", [
    (1, 64, 2, 2, 16, True), (2, 96, 4, 2, 32, True),
    (1, 128, 4, 1, 64, True), (2, 64, 2, 2, 16, False),
    (2, 96, 4, 4, 48, False), (1, 200, 2, 2, 128, True),
    (2, 130, 2, 1, 80, True), (1, 70, 1, 1, 256, True),
    (4, 1024, 32, 32, 64, True),
    (1, 2048, 4, 2, 64, True),        # many key tiles
    (2, 1000, 4, 4, 64, True),        # Lq not a multiple of 128
    (1, 384, 8, 2, 128, True),        # d 128, GQA rep 4
    (1, 256, 8, 2, 256, True),        # d 256, GQA rep 4
    (2, 256, 4, 1, 256, False)])
def test_flash_kernel_matches_plain(cuda, b, l, hq, hkv, d, causal):
    q, k, v = _qkv(cuda, b, l, hq, hkv, d)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal)
    assert flash_attention.launches == before + 1
    torch.cuda.synchronize()
    torch.testing.assert_close(out, flash_attention_ref(q, k, v,
                                                        causal=causal),
                               rtol=2e-4, atol=2e-5)


def test_flash_kernel_from_bf16(cuda):
    q, k, v = _qkv(cuda, 2, 96, 4, 2, 64, torch.bfloat16)
    out = flash_attention(q, k, v)
    assert out.dtype == torch.bfloat16
    ref = flash_attention_ref(q, k, v).to(torch.bfloat16)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2 ** -7,
                               atol=2e-5)


@pytest.mark.parametrize("d", [24, 8, 272])
def test_flash_kernel_refuses_head_dims(cuda, d):
    q, k, v = _qkv(cuda, 1, 32, 2, 2, d)
    before = flash_attention.launches
    with pytest.raises(ValueError, match="head dims"):
        flash_attention(q, k, v)
    assert flash_attention.launches == before


def _tf32(t):
    """``t`` rounded to TF32 (10 mantissa bits, to nearest): what one
    TF32 tensor-core pass would read."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def test_flash_kernel_non_causal_lq_past_lk(cuda):
    """Lq != Lk (no mask), with a ragged last query tile."""
    g = torch.Generator().manual_seed(3)
    q = torch.randn(1, 300, 4, 64, generator=g).to(cuda)
    k, v = (torch.randn(1, 256, 2, 64, generator=g).to(cuda)
            for _ in range(2))
    out = flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, flash_attention_ref(q, k, v,
                                                        causal=False),
                               rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("b,l,h", [(2, 512, 8), (1, 8192, 2)])
def test_flash_kernel_keeps_f32_error_on_peaked_softmax(cuda, b, l, h):
    """q and k scaled by 4: scores spread about 16 make the softmax peaked.
    Held to the exact attention (the plain function in float64) at the
    kernel tolerance, and to the plain f32 version's own error there:
    one TF32 pass over q and k misses the tolerance by far (checked on
    the plain version), so passing shows the split precision. (Against
    the plain f32 version the two errors would add: its own error
    against exact is close to the tolerance here.) At L 8192 the last
    query rows sum over 256 key tiles: the sums do not drift as they
    grow."""
    q, k, v = _qkv(cuda, b, l, h, h, 64)
    q, k = 4 * q, 4 * k

    def heads(t):
        return t.permute(0, 2, 1, 3).reshape(-1, t.shape[1], t.shape[3])

    exact = attention_ref(*(heads(t).double() for t in (q, k, v)))
    exact = exact.reshape(b, h, l, 64).permute(0, 2, 1, 3)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(
            flash_attention_ref(_tf32(q), _tf32(k), v).double(), exact,
            rtol=2e-4, atol=2e-5)
    out = flash_attention(q, k, v).double()
    torch.cuda.synchronize()
    torch.testing.assert_close(out, exact, rtol=2e-4, atol=2e-5)
    plain = flash_attention_ref(q, k, v).double()
    assert (out - exact).abs().max() <= (plain - exact).abs().max()


def _ssd_args(cuda, bsz, L, H, P, N, dtype=torch.float32):
    g = torch.Generator().manual_seed(L * H + P)
    log_a = -torch.rand(bsz, L, H, generator=g) * 0.3
    x = torch.randn(bsz, L, H, P, generator=g)
    b = torch.randn(bsz, L, N, generator=g) * 0.3
    c = torch.randn(bsz, L, N, generator=g) * 0.3
    return [log_a.to(cuda)] + [t.to(cuda, dtype) for t in (x, b, c)]


@pytest.mark.parametrize("bsz,L,H,P,N,chunk", [
    (1, 64, 2, 16, 8, 16), (2, 100, 3, 16, 8, 32), (1, 32, 1, 64, 16, 32),
    (2, 37, 4, 8, 16, 128), (2, 64, 8, 16, 16, 16), (1, 300, 2, 64, 64, 128),
    (1, 50, 3, 6, 5, 7),
    (1, 4096, 4, 64, 64, 128),    # 32 chained chunks
    (1, 256, 64, 64, 64, 128),    # zamba2's heads: group-shared C B^T
    (2, 1000, 9, 64, 64, 128),    # ragged last chunk, a partial head group
    (1, 130, 3, 32, 16, 64),      # ragged, P of one half
    (1, 300, 3, 64, 128, 64),     # mamba2-130m's state: N 128, P 64, Q 64
    (1, 200, 2, 128, 64, 64),     # two P tiles
    (2, 260, 9, 80, 130, 128),    # three N tiles, a ragged P tile
    (1, 300, 3, 64, 128, 128),    # one group of warps: two x tiles won't fit
    (1, 400, 2, 64, 64, 152),     # a chunk past 128 steps, 10 row tiles
    (1, 300, 3, 64, 128, 144)])   # both
def test_ssd_kernel_matches_plain(cuda, bsz, L, H, P, N, chunk):
    args = _ssd_args(cuda, bsz, L, H, P, N)
    before = ssd_scan.launches
    out = ssd_scan(*args, chunk=chunk)
    assert ssd_scan.launches == before + 1
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ssd_scan_ref(*args), rtol=2e-4,
                               atol=2e-4)


def test_ssd_kernel_from_bf16(cuda):
    args = _ssd_args(cuda, 2, 160, 4, 32, 16, torch.bfloat16)
    out = ssd_scan(*args, chunk=64)
    assert out.dtype == torch.bfloat16
    ref = ssd_scan_ref(*args).to(torch.bfloat16)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2 ** -7,
                               atol=2e-4)


def test_ssd_kernel_refuses_a_chunk_past_shared_memory(cuda):
    """A chunk past what the tiles fit runs at the longest chunk that
    fits (see the next test); a state so wide that no chunk's tiles fit
    (N 4096: 16 steps of B alone pass shared memory) is refused."""
    args = _ssd_args(cuda, 1, 64, 1, 64, 4096)
    before = ssd_scan.launches
    with pytest.raises(RuntimeError, match="ssd_scan"):
        ssd_scan(*args, chunk=16)
    assert ssd_scan.launches == before


@pytest.mark.parametrize("N", [64, 128])
@pytest.mark.parametrize("chunk", [200, 228, 512])
def test_ssd_kernel_runs_chunks_past_its_tiles(cuda, N, chunk):
    """Chunks the reference computes but the tiles do not fit (past 160
    steps at N 64, past 144 at N 128) run at the longest chunk that fits,
    within the chunked-scan tolerance (rtol = atol = 2e-4) of the plain
    recurrence."""
    args = _ssd_args(cuda, 2, 600, 3, 64, N)
    before = ssd_scan.launches
    out = ssd_scan(*args, chunk=chunk)
    assert ssd_scan.launches == before + 1
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ssd_scan_ref(*args), rtol=2e-4,
                               atol=2e-4)


def test_zamba2_smoke_on_card_matches_cpu(cuda):
    from repro_torch.configs import get_smoke
    from repro_torch.launch.serve import serve_session
    from repro_torch.models import get_model
    from repro_torch.models.hybrid import n_attn_invocations

    cfg = get_smoke("zamba2-1.2b", use_flash_kernel=True,
                    use_ssd_kernel=True)
    cpu = get_model(cfg, device="cpu")
    params = cpu.init_params(0)
    card = get_model(cfg, device=cuda)
    def to_card(tree):
        return {k: to_card(v) if isinstance(v, dict) else v.to(cuda)
                for k, v in tree.items()}

    cparams = to_card(params)
    g = torch.Generator().manual_seed(7)
    tokens = torch.randint(0, cfg.vocab_size, (2, 40), generator=g,
                           dtype=torch.int32)
    batch = {"tokens": tokens, "labels": tokens}
    kernels.reset_launch_counts()
    h, _ = card.forward(cparams, {k: t.to(cuda) for k, t in batch.items()})
    assert kernels.launch_counts()["ssd_scan"] == cfg.n_layers
    ref, _ = cpu.forward(params, batch)
    torch.testing.assert_close(h.cpu(), ref, rtol=1e-4, atol=1e-4)

    kw = dict(requests=4, batch=2, prompt_len=24, max_new=6)
    kernels.reset_launch_counts()
    got, stats = serve_session(cfg, params=cparams, device=cuda, **kw)
    assert kernels.launch_counts()["flash_attention"] == \
        2 * n_attn_invocations(cfg)
    want, _ = serve_session(cfg, params=params, device="cpu", **kw)
    np.testing.assert_array_equal(got, want)
    assert stats["peak_memory_bytes"] > 0


# ---------------------------------------------------------------------------
# The serving path: pinned staging, the copy stream, CUDA-graph replay and
# the multi-tenant scheduler
# ---------------------------------------------------------------------------

SERVE_SMALL = dict(n_c=16, n_f=8, nz=32, nx=32)


def _serve_cfg(variant, modality, fusion="none"):
    return tiny_config(variant=variant, modality=modality, fusion=fusion,
                       **SERVE_SMALL)


@pytest.mark.parametrize("modality", ["bmode", "power_doppler"])
@pytest.mark.parametrize("variant,fusion", [("dynamic", "none"),
                                            ("dynamic", "fused"),
                                            ("sparse", "none")])
def test_graph_replay_is_bit_equal_to_eager(cuda, variant, fusion,
                                            modality):
    """The captured engine replays the same kernels on the same inputs:
    bit-equal to the eager dispatch, and it counts each replay's
    launches (the wrappers' own counters do not move)."""
    from repro_torch.core.aot import aot_warm

    cfg = _serve_cfg(variant, modality, fusion)
    rf = np.stack([synth_rf(cfg, seed=s) for s in range(3)])
    want = BatchedExecutor(cfg).dispatch_padded(rf, 4).cpu()
    ex = BatchedExecutor(cfg)
    prog = aot_warm(ex, 4)
    assert prog.compile_s > 0.0 and prog.warmup_s > prog.compile_s
    assert prog.launches and set(prog.launches.values()) == {1}
    kernels.reset_launch_counts()
    outs = [ex.dispatch_padded(rf, 4) for _ in range(3)]
    assert set(kernels.launch_counts().values()) == {0}
    assert kernels.replayed_launch_counts() == {
        k: 3 * prog.launches.get(k, 0) for k in kernels.launch_counts()}
    for out in outs:                       # each replay its own output
        assert torch.equal(out.cpu(), want)


def test_place_and_dispatch_staged_equal_call(cuda):
    cfg = _serve_cfg("dynamic", "bmode")
    rf = np.stack([synth_rf(cfg, seed=s) for s in range(4)])
    ex = BatchedExecutor(cfg)
    want = ex(rf).cpu()
    staged = ex.place(rf)
    assert staged.device.type == "cuda" and staged.h2d_event is not None
    assert torch.equal(ex.dispatch_staged(staged, 4).cpu(), want)
    pinned = torch.from_numpy(rf).pin_memory()
    assert torch.equal(ex.dispatch_staged(ex.place(pinned), 4).cpu(), want)
    on_card = torch.from_numpy(rf).to(cuda)
    assert ex.place(on_card) is on_card
    assert torch.equal(ex(on_card).cpu(), want)


def test_staging_slots_and_source_pool_are_pinned(cuda):
    from repro_torch.core.staging import StagingRing
    from repro_torch.launch.serve import SyntheticAcquisitionSource

    cfg = _serve_cfg("dynamic", "bmode")
    ring = StagingRing(4, cfg.rf_shape, cfg.rf_dtype, depth=2,
                       pin_memory=True)
    frames = [synth_rf(cfg, seed=s) for s in range(3)]
    for _ in range(ring.slots):
        buf, _ = ring.stage(frames)
        assert torch.from_numpy(buf).is_pinned()
        assert np.array_equal(buf[:3], np.stack(frames))
        assert not buf[3:].any()
    source = SyntheticAcquisitionSource(cfg, 2, pool=2, pin_memory=True)
    for _ in range(2):
        assert torch.from_numpy(source.next()).is_pinned()


def test_slot_rewrite_waits_for_the_copy(cuda):
    """A pinned slot whose copy is still queued (held back by a sleep
    kernel on the copy stream) must not be rewritten; the scheduler's
    rule — rewrite only once the batch's compute event, which waits on
    the copy, has completed — is safe: the batch still computes from
    the bytes staged, though the slot is rewritten at once after."""
    from repro_torch.core.staging import StagingRing

    cfg = _serve_cfg("dynamic", "power_doppler")
    frames = [synth_rf(cfg, seed=s) for s in range(4)]
    ex = BatchedExecutor(cfg)
    want = ex(np.stack(frames)).cpu()
    ring = StagingRing(4, cfg.rf_shape, cfg.rf_dtype, depth=1,
                       pin_memory=True)
    buf, _ = ring.stage(frames)
    with torch.cuda.stream(ex.copy_stream):
        torch.cuda._sleep(500_000_000)     # about 0.25 s at 2 GHz
    staged = ex.place(buf)
    assert not staged.h2d_event.query()    # the copy has not run yet
    out = ex.dispatch_staged(staged, 4)
    done = torch.cuda.Event()
    done.record()
    assert not done.query()
    done.synchronize()                     # the batch has settled ...
    assert staged.h2d_event.query()        # ... so its copy has too
    ring.stage([np.full(cfg.rf_shape, 1234, np.int16)] * 4)
    buf2, _ = ring.stage([np.full(cfg.rf_shape, 77, np.int16)] * 2)
    assert buf2 is buf                     # the slot came round again
    assert torch.equal(out.cpu(), want)


@pytest.mark.parametrize("drain", ["async", "block"])
def test_serve_multitenant_on_card_passes_the_oracle(cuda, drain):
    """A short window on the card: every served frame equals the frame
    alone through the same engine (eager, at the padded shape) bit for
    bit, and the plain monolithic pipeline within the image tolerances
    (the kernels sum the channels in another order); the window has
    pinned rings, graph replays and measured energy."""
    from repro_torch.core.aot import warm_pool
    from repro_torch.launch.scheduler import (BatchPolicy,
                                              make_mixed_streams,
                                              serve_multitenant)

    cfg = _serve_cfg("dynamic", "bmode")
    streams = make_mixed_streams(3, cfg,
                                 cfg.with_(modality="doppler"),
                                 base_fps=400.0, n_frames=6)
    pool = warm_pool(streams, max_batch=4)
    kernels.reset_launch_counts()
    stats = serve_multitenant(streams, policy=BatchPolicy(4, 2.0),
                              in_flight=2, drain=drain, pool=pool,
                              collect_outputs=True)
    assert set(kernels.launch_counts().values()) == {0}
    assert kernels.replayed_launch_counts()["das_beamform"] == \
        stats["occupancy"]["batches"]
    assert stats["in_flight_occupancy"]["max_depth"] <= 2
    assert stats["occupancy"]["max_occupancy"] <= 4
    assert stats["resources"]["energy_joules"] is not None
    assert stats["resources"]["memory_source"] == \
        "torch.cuda.max_memory_allocated"
    for spec in streams:
        eager = BatchedExecutor(spec.cfg)
        consts = consts_from_numpy(init_pipeline(eager.cfg), cuda)
        plain = monolithic_pipeline_fn(eager.cfg)
        tol = 1.2e-3 if spec.cfg.modality.value == "bmode" else 1e-4
        for k, out in enumerate(stats["outputs"][spec.stream_id]):
            rf = synth_rf(spec.cfg, seed=spec.frame_seed(k))
            alone = eager.call_padded(rf[None], 4)[0].cpu().numpy()
            assert np.array_equal(out, alone), (spec.stream_id, k)
            ref = plain(consts, torch.from_numpy(rf)[None].to(cuda))[0]
            assert np.abs(out - ref.cpu().numpy()).max() <= tol


def test_autotune_on_card_picks_its_argmin_and_frees_its_probes(cuda):
    """Autotune at the paper's geometry: the pick is the argmin of its
    own CUDA-event timings, no stage with a kernel lowering resolves to
    its plain version, and the probes (the cnn operator is 2.8 GB) leave
    nothing allocated."""
    from repro_torch.core import lowering, plan as plan_lib
    from repro_torch.core import plan_pipeline

    plan_lib.clear_autotune_memo()
    # cuBLAS keeps a 32 MiB workspace once it has run: make it first
    torch.ones(8, 8, device=cuda) @ torch.ones(8, 8, device=cuda)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(cuda)
    cfg = paper_config(variant="auto")
    plan = plan_pipeline(cfg, policy="autotune", backend="cuda",
                         autotune_runs=2)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(cuda) - before < 1e6
    t = dict(plan.autotune_t_s)
    assert set(t) == {"dynamic", "cnn", "sparse"}
    assert plan.variant.value == min(t, key=t.get)
    c = plan.concretize(cfg)
    for stage, name in plan.stage_lowerings:
        kernels_of = set(lowering.available_lowerings(c, stage, "cuda"))
        assert name != "xla" or kernels_of == {"xla"}, (stage, name)
    plan_lib.clear_autotune_memo()


@pytest.mark.parametrize("variant,fusion", [("dynamic", "none"),
                                            ("dynamic", "fused"),
                                            ("sparse", "none")])
def test_sharded_executor_on_one_card_is_bit_equal(cuda, variant, fusion):
    """Two shards on the one card, each on its own copy and compute
    stream: bit-equal to `BatchedExecutor` on uneven and even batches."""
    from repro_torch.core import ShardedExecutor

    cfg = _serve_cfg(variant, "power_doppler", fusion)
    eng = ShardedExecutor(cfg, devices=["cuda:0", "cuda:0"])
    assert eng.plan.devices == 2 and len(set(map(id, eng.streams))) == 2
    ref = BatchedExecutor(cfg)
    for b in (1, 4, 5):
        rf = np.stack([synth_rf(cfg, seed=s) for s in range(b)])
        assert torch.equal(eng(rf).cpu(), ref(rf).cpu()), b
    shards = eng.dispatch(np.stack([synth_rf(cfg, seed=s)
                                    for s in range(4)]))
    assert [s.shape[0] for s in shards] == [2, 2]
    for s in shards:
        s.done_event.synchronize()


@pytest.mark.parametrize("variant,kernel", [("dynamic", "das_beamform"),
                                            ("sparse", "bsr_beamform")])
def test_sharded_warm_pool_replays_bit_equal_to_eager(cuda, variant,
                                                      kernel):
    """A warm pool over two shards captures one graph a shard; its
    replays, on two streams at once, equal the eager engine, and every
    served frame the lone frame, bit for bit."""
    from repro_torch.core.aot import warm_pool
    from repro_torch.launch.scheduler import (BatchPolicy,
                                              make_mixed_streams,
                                              serve_multitenant)

    cfg = _serve_cfg(variant, "bmode")
    streams = make_mixed_streams(2, cfg, cfg.with_(modality="doppler"),
                                 base_fps=400.0, n_frames=5)
    devices = ["cuda:0", "cuda:0"]
    pool = warm_pool(streams, max_batch=4, devices=devices)
    for key in pool.keys():
        entry = pool.get(key)
        assert key[2] == 2 and entry.program.devices == 2
        assert entry.program.launches == {kernel: 2}
        rf = np.stack([synth_rf(entry.engine.cfg, seed=s)
                       for s in range(3)])
        replay = entry.engine.call_padded(rf, 4).cpu()
        eager = BatchedExecutor(entry.engine.cfg).call_padded(rf, 4).cpu()
        assert torch.equal(replay, eager)
    kernels.reset_launch_counts()
    stats = serve_multitenant(streams, policy=BatchPolicy(4, 2.0),
                              devices=devices, pool=pool,
                              collect_outputs=True)
    assert set(kernels.launch_counts().values()) == {0}
    assert kernels.replayed_launch_counts()[kernel] == \
        2 * stats["occupancy"]["batches"]
    for spec in streams:
        eager = BatchedExecutor(spec.cfg)
        for k, out in enumerate(stats["outputs"][spec.stream_id]):
            alone = eager.call_padded(spec.frame_rf(k)[None], 4)
            assert np.array_equal(out, alone[0].cpu().numpy())


def _cards(n):
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA devices")
    return [f"cuda:{i}" for i in range(n)]


@pytest.mark.parametrize("n_cards", [2, 4])
def test_sharded_executor_across_cards_is_bit_equal(cuda, n_cards):
    """One shard a card: every variant's images equal `BatchedExecutor`'s
    on the first card, bit for bit, on uneven and even batches, and each
    shard's output lies on its own card."""
    from repro_torch.core import ShardedExecutor

    devices = _cards(n_cards)
    every = ShardedExecutor(_serve_cfg("dynamic", "bmode"))
    assert every.n_devices == torch.cuda.device_count()
    for variant, fusion in [("dynamic", "none"), ("dynamic", "fused"),
                            ("sparse", "none"), ("cnn", "none")]:
        cfg = _serve_cfg(variant, "power_doppler", fusion)
        eng = ShardedExecutor(cfg, devices=devices)
        ref = BatchedExecutor(cfg, device="cuda:0")
        for b in (1, n_cards, n_cards + 1):
            rf = np.stack([synth_rf(cfg, seed=s) for s in range(b)])
            assert torch.equal(eng(rf).cpu(), ref(rf).cpu()), (variant, b)
        shards = eng.dispatch(np.stack([synth_rf(cfg, seed=s)
                                        for s in range(n_cards)]))
        assert [str(s.device) for s in shards] == devices
        for s in shards:
            s.done_event.synchronize()


@pytest.mark.parametrize("variant", ["dynamic", "sparse"])
def test_scheduler_across_cards_serves_the_lone_frame(cuda, variant):
    """A warm pool over two cards (one graph a card) serves every frame
    equal to the lone frame through the engine on the first card."""
    from repro_torch.core.aot import warm_pool
    from repro_torch.launch.scheduler import (BatchPolicy,
                                              make_mixed_streams,
                                              serve_multitenant)

    devices = _cards(2)
    cfg = _serve_cfg(variant, "bmode")
    streams = make_mixed_streams(2, cfg, cfg.with_(modality="doppler"),
                                 base_fps=400.0, n_frames=5)
    pool = warm_pool(streams, max_batch=4, devices=devices)
    stats = serve_multitenant(streams, policy=BatchPolicy(4, 2.0),
                              devices=devices, pool=pool,
                              collect_outputs=True)
    assert all(g["plan"]["devices"] == 2 for g in stats["groups"].values())
    for spec in streams:
        eager = BatchedExecutor(spec.cfg, device="cuda:0")
        for k, out in enumerate(stats["outputs"][spec.stream_id]):
            alone = eager.call_padded(spec.frame_rf(k)[None], 4)
            assert np.array_equal(out, alone[0].cpu().numpy())
