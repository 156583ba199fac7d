"""The port's staging ring and the executor's staged dispatch, on the CPU.

The ring contract of the reference (`repro.core.staging`): slots cycle
round-robin, pad rows are zero, a slot dirtied past a later occupancy is
re-zeroed, and a ring smaller than ``depth + 1`` slots cannot be built.
On the same sequence of coalesced batches the port's buffers are
byte-equal to the reference ring's. The pinned rings that serve the
card are held on the card (tests/test_torch_gpu.py): a CPU-only torch
build cannot pin, so nothing here asks it to.

The executor's staged pair: `place` returns a copy (the caller's slot is
free to be rewritten), ``dispatch_staged(place(x))`` equals the
executor's call bit for bit, and `dispatch_padded` slices nothing.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from repro.core.staging import StagingRing as RefRing  # noqa: E402

from repro_torch.core import BatchedExecutor, tiny_config  # noqa: E402
from repro_torch.core.staging import StagingRing  # noqa: E402
from repro_torch.data import synth_rf  # noqa: E402

SMALL = dict(n_c=16, n_f=8, nz=32, nx=32)


def _frames(shape, dtype, n, start=0):
    return [np.full(shape, start + k, dtype=dtype) for k in range(n)]


def test_pad_rows_zero_and_rows_in_order():
    ring = StagingRing(4, (2, 3), np.float32, depth=2)
    frames = _frames((2, 3), np.float32, 3, start=1)
    buf, b = ring.stage(frames)
    assert b == 3
    assert buf.shape == (4, 2, 3) and buf.dtype == np.float32
    for r in range(3):
        assert np.array_equal(buf[r], frames[r])
    assert not buf[3:].any()


def test_partial_after_full_rezeros_stale_tail():
    ring = StagingRing(4, (2,), np.int16, depth=1, slots=2)
    ring.stage(_frames((2,), np.int16, 4, start=10))
    ring.stage(_frames((2,), np.int16, 4, start=20))
    buf, b = ring.stage(_frames((2,), np.int16, 1, start=30))
    assert b == 1
    assert np.all(buf[0] == 30)
    assert not buf[1:].any()


def test_slots_cycle_round_robin():
    ring = StagingRing(2, (1,), np.float32, depth=2)     # 3 slots
    bufs = [ring.stage(_frames((1,), np.float32, 1))[0]
            for _ in range(ring.slots + 1)]
    ids = [id(b) for b in bufs]
    assert len(set(ids[:ring.slots])) == ring.slots
    assert ids[ring.slots] == ids[0]
    assert ring.batches_staged == ring.slots + 1
    assert ring.stage_copy_s > 0.0


def test_empty_and_oversized_batches_refused():
    ring = StagingRing(2, (1,), np.float32, depth=1)
    with pytest.raises(ValueError, match="empty RF batch"):
        ring.stage([])
    with pytest.raises(ValueError, match="exceeds pad_to"):
        ring.stage(_frames((1,), np.float32, 3))


@pytest.mark.parametrize("depth,slots", [(1, 1), (2, 2), (3, 2), (4, 4)])
def test_slots_below_depth_plus_one_refused(depth, slots):
    for ring in (StagingRing, RefRing):
        with pytest.raises(ValueError, match="cannot back in_flight"):
            ring(4, (2,), np.float32, depth=depth, slots=slots)


def test_invalid_geometry_refused_and_minimum_ring_builds():
    with pytest.raises(ValueError, match="pad_to"):
        StagingRing(0, (2,), np.float32, depth=1)
    with pytest.raises(ValueError, match="depth"):
        StagingRing(4, (2,), np.float32, depth=0)
    assert StagingRing(4, (2,), np.float32, depth=3, slots=4).slots == 4
    assert StagingRing(4, (2,), np.float32, depth=3).slots == 4


@pytest.mark.parametrize("depth,slots", [(1, None), (2, None), (2, 5)])
def test_buffers_byte_equal_to_reference_ring(depth, slots):
    """The same coalesced batches, with occupancies rising and falling
    across wraps, leave byte-identical buffers in both rings."""
    cfg = tiny_config(**SMALL)
    rng = np.random.default_rng(depth)
    rf = [synth_rf(cfg, seed=s) for s in range(6)]
    port = StagingRing(4, cfg.rf_shape, cfg.rf_dtype, depth=depth,
                       slots=slots)
    ref = RefRing(4, cfg.rf_shape, cfg.rf_dtype, depth=depth, slots=slots)
    for _ in range(3 * port.slots):
        b = int(rng.integers(1, 5))
        pick = [rf[int(i)] for i in rng.integers(0, len(rf), b)]
        got, nb = port.stage(pick)
        want, nr = ref.stage(pick)
        assert nb == nr == b
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert port.batches_staged == ref.batches_staged


def test_place_copies_on_the_cpu():
    cfg = tiny_config(variant="dynamic", **SMALL)
    ex = BatchedExecutor(cfg, device="cpu")
    assert ex.copy_stream is None and ex.donate is False
    buf = np.stack([synth_rf(cfg, seed=s) for s in range(2)])
    staged = ex.place(buf)
    keep = staged.clone()
    buf[:] = 7                                     # rewrite the slot
    assert torch.equal(staged, keep)
    assert ex.input_bytes_per_acq == cfg.input_bytes
    assert ex.name == f"{cfg.name}:dynamic:vmap"


@pytest.mark.parametrize("variant", ["dynamic", "cnn", "sparse"])
def test_staged_dispatch_equals_call(variant):
    cfg = tiny_config(variant=variant, modality="power_doppler", **SMALL)
    ex = BatchedExecutor(cfg, device="cpu")
    rf = np.stack([synth_rf(cfg, seed=s) for s in range(3)])
    want = ex(rf)
    assert torch.equal(ex.dispatch_staged(ex.place(rf), 3), want)
    padded = ex.dispatch_padded(rf[:2], 4)
    assert padded.shape[0] == 4
    assert torch.equal(padded[:2], ex.call_padded(rf[:2], 4))
    with pytest.raises(ValueError, match="dispatch shape"):
        ex.dispatch_staged(ex.place(rf), 4)
    with pytest.raises(ValueError, match="exceeds pad_to"):
        ex.call_padded(rf, 2)
