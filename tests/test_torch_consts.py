"""PyTorch port vs JAX reference: configs, constants and synthetic data.

The port keeps its own copies of the numpy-only modules; these tests pin
them to the reference: equal config hashes, array-equal constants,
byte-equal RF and seeds.
"""

import collections

import numpy as np
import pytest

pytest.importorskip("torch")

import torch  # noqa: E402

from repro.core import config as jcfg  # noqa: E402
from repro.core import delays as jdelays  # noqa: E402
from repro.core import stages as jstages  # noqa: E402
from repro.data import seed_space as j_seed_space  # noqa: E402
from repro.data import synth_rf as j_synth_rf  # noqa: E402

from repro_torch.core import config as tcfg  # noqa: E402
from repro_torch.core import delays as tdelays  # noqa: E402
from repro_torch.core import pipeline as tpipe  # noqa: E402
from repro_torch.core import stages as tstages  # noqa: E402
from repro_torch.core.pipeline import consts_from_numpy, init_pipeline  # noqa: E402
from repro_torch.data import seed_space, synth_rf  # noqa: E402

MODALITIES = ("bmode", "doppler", "power_doppler")
GEOMETRIES = ("tiny", "paper")


def _pair(geometry, **kw):
    jkw = dict(kw)
    if "modality" in jkw:
        jkw["modality"] = jcfg.Modality(jkw["modality"])
    if "variant" in jkw:
        jkw["variant"] = jcfg.Variant(jkw["variant"])
    j = getattr(jcfg, f"{geometry}_config")(**jkw)
    t = getattr(tcfg, f"{geometry}_config")(**kw)
    return j, t


@pytest.mark.parametrize("geometry", GEOMETRIES)
@pytest.mark.parametrize("modality", MODALITIES)
def test_config_hash_matches_reference(geometry, modality):
    for kw in ({}, {"variant": "dynamic"},
               {"variant": "dynamic", "fusion": "fused", "precision": "bf16"},
               {"stage_lowerings": {"beamform": "pallas"}},
               {"exec_map": "map", "n_f": 8}):
        j, t = _pair(geometry, modality=modality, **kw)
        assert tcfg.config_hash(t) == jcfg.config_hash(j), kw
        assert (tcfg.config_hash(t, exclude=("variant", "exec_map"))
                == jcfg.config_hash(j, exclude=("variant", "exec_map")))
    assert tcfg.CONFIG_HASH_SCHEMA == jcfg.CONFIG_HASH_SCHEMA


def test_config_fields_match_reference():
    import dataclasses
    names = [f.name for f in dataclasses.fields(tcfg.UltrasoundConfig)]
    assert names == [f.name for f in dataclasses.fields(
        jcfg.UltrasoundConfig)]
    assert tcfg.paper_config().input_bytes == 5_472_256
    assert tcfg.PRECISION_TOLERANCES.keys() == {
        (p, tcfg.Modality(m.value)) for p, m in jcfg.PRECISION_TOLERANCES}


def test_config_validation_matches_reference():
    for bad in ({"exec_map": "scan"}, {"fusion": "all"},
                {"precision": "fp8"}, {"fusion_block": 64},
                {"stage_lowerings": {"beamform": "triton"}},
                {"stage_lowerings": {"head": "xla"}}):
        with pytest.raises(ValueError):
            jcfg.tiny_config(**bad)
        with pytest.raises(ValueError):
            tcfg.tiny_config(**bad)


@pytest.mark.parametrize("geometry", GEOMETRIES)
@pytest.mark.parametrize("modality", ("bmode", "power_doppler"))
def test_init_graph_consts_array_equal(geometry, modality):
    j, t = _pair(geometry, variant="dynamic", modality=modality)
    ref = jstages.init_graph_consts(j)
    out = tstages.init_graph_consts(t)
    assert sorted(out) == sorted(ref)
    for k in ref:
        assert out[k].dtype == ref[k].dtype, k
        assert np.array_equal(out[k], ref[k]), k


def test_consts_from_numpy_copies_and_adds_int64_index():
    t = tcfg.tiny_config(variant="dynamic")
    consts = init_pipeline(t)
    assert not consts["idx"].flags.writeable    # the cache is read-only
    out = consts_from_numpy(consts, "cpu")
    assert out["idx"].dtype == torch.int32
    assert out["idx_long"].dtype == torch.int64
    assert torch.equal(out["idx_long"], out["idx"].long())
    for k, a in consts.items():
        assert np.array_equal(out[k].numpy(), a), k
    out["frac"][0, 0] = -1.0                    # a copy, not a view
    assert consts["frac"][0, 0] != -1.0


def _bits_equal(out, ref):
    return (out.dtype == ref.dtype and out.shape == ref.shape
            and out.tobytes() == ref.tobytes())


# tiny, the wide test geometry, and one at the paper's 64 x 64 blocks
OPERATOR_GEOMETRIES = ({}, dict(n_c=16, n_f=8, nz=32, nx=32),
                       dict(n_c=16, nz=64, nx=32, sparse_block_p=64,
                            sparse_block_s=64))


@pytest.mark.parametrize("kw", OPERATOR_GEOMETRIES)
def test_interp_matrix_bit_equal(kw):
    j, t = _pair("tiny", **kw)
    ref = jdelays.interp_matrix(j, jdelays.compute_delay_tables(j))
    out = tdelays.interp_matrix(t, tdelays.compute_delay_tables(t))
    assert _bits_equal(out, ref)


@pytest.mark.parametrize("kw", OPERATOR_GEOMETRIES)
def test_bsr_operator_bit_equal(kw):
    """Built straight from the taps, the port's BSR operator is the
    reference's (built from the padded dense operator) bit for bit."""
    j, t = _pair("tiny", **kw)
    ref = jdelays.bsr_operator(j, jdelays.compute_delay_tables(j))
    out = tdelays.bsr_operator(t, tdelays.compute_delay_tables(t))
    assert _bits_equal(out.blocks, ref.blocks)
    assert _bits_equal(out.col_idx, ref.col_idx)
    assert (out.bp, out.bs, out.nnz_ratio) == (ref.bp, ref.bs, ref.nnz_ratio)
    assert out.blocks.shape[2] >= 2         # padded K slots are exercised


@pytest.mark.parametrize("variant", ("cnn", "sparse"))
def test_ported_variant_consts_bit_equal(variant):
    """The cnn and sparse constants (refused before these variants were
    ported) are the reference's arrays, under the reference's keys."""
    j, t = _pair("tiny", variant=variant, modality="power_doppler", n_c=16,
                 n_f=8, nz=32, nx=32)
    ref = jstages.init_graph_consts(j)
    out = tstages.init_graph_consts(t)
    assert sorted(out) == sorted(ref)
    for k in ref:
        assert _bits_equal(out[k], ref[k]), k


def test_consts_cache_bounded_in_bytes(monkeypatch):
    """LRU by bytes, as the reference: an entry over the budget is served
    uncached, and older entries go once the total passes it."""
    monkeypatch.setattr(tpipe, "_MEM_CACHE", collections.OrderedDict())
    a = tcfg.tiny_config(variant="dynamic")
    b = tcfg.tiny_config(variant="sparse")
    size_a = tpipe._consts_nbytes(init_pipeline(a))
    size_b = tpipe._consts_nbytes(init_pipeline(b))
    assert len(tpipe._MEM_CACHE) == 2
    monkeypatch.setattr(tpipe, "MEM_CACHE_MAX_BYTES", size_a + size_b - 1)
    tpipe._MEM_CACHE.clear()
    init_pipeline(a)
    init_pipeline(b)                         # evicts a, the older entry
    assert len(tpipe._MEM_CACHE) == 1
    assert init_pipeline(b)["bsr_blocks"] is init_pipeline(b)["bsr_blocks"]
    big = tcfg.tiny_config(variant="cnn")
    monkeypatch.setattr(tpipe, "MEM_CACHE_MAX_BYTES", size_b)
    first, second = init_pipeline(big), init_pipeline(big)
    assert first["interp_matrix"] is not second["interp_matrix"]
    assert np.array_equal(first["interp_matrix"], second["interp_matrix"])
    assert not first["interp_matrix"].flags.writeable
    assert len(tpipe._MEM_CACHE) == 1       # b stays; big is uncached


@pytest.mark.parametrize("seed", (0, 7))
def test_synth_rf_byte_equal(seed):
    j, t = _pair("tiny", n_c=16, n_f=8)
    ref = j_synth_rf(j, seed=seed)
    out = synth_rf(t, seed=seed)
    assert out.dtype == ref.dtype and out.tobytes() == ref.tobytes()


def test_seed_space_equal():
    for parts in (("source", 0, 0), ("source", 3, 17), ("mt", "a", 1.5)):
        assert seed_space(*parts) == j_seed_space(*parts)
