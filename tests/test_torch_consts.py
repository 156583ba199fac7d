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


# ---------------------------------------------------------------------------
# The disk tier (the reference's two-tier cache, with the port's own tag)
# ---------------------------------------------------------------------------


@pytest.fixture
def disk_dir(tmp_path):
    """Both packages' disk tiers pointed at one fresh directory, their
    memory tiers empty; restored afterwards."""
    from repro.core import pipeline as jpipe

    prev = (tpipe.consts_cache_dir(), jpipe.consts_cache_dir())
    tpipe.set_consts_cache_dir(str(tmp_path))
    jpipe.set_consts_cache_dir(str(tmp_path))
    tpipe.clear_consts_cache()
    jpipe.clear_consts_cache()
    tpipe.CONSTS_CACHE_STATS.reset()
    yield tmp_path
    tpipe.set_consts_cache_dir(prev[0])
    jpipe.set_consts_cache_dir(prev[1])
    tpipe.clear_consts_cache()


@pytest.mark.parametrize("variant", ("dynamic", "cnn", "sparse"))
def test_disk_tier_round_trip_is_bit_equal(disk_dir, variant):
    stats = tpipe.CONSTS_CACHE_STATS
    cfg = tcfg.tiny_config(variant=variant, nz=20)
    fresh = init_pipeline(cfg)
    assert (stats.misses, stats.mem_hits, stats.disk_hits) == (1, 0, 0)
    files = [p.name for p in disk_dir.iterdir()]
    assert len(files) == 1 and files[0].startswith("consts-torch-v1-")
    init_pipeline(cfg.with_(exec_map="map"))          # same constants
    assert (stats.misses, stats.mem_hits, stats.disk_hits) == (1, 1, 0)
    tpipe.clear_consts_cache()                        # a restart
    cached = init_pipeline(cfg)
    assert (stats.misses, stats.mem_hits, stats.disk_hits) == (1, 1, 1)
    assert sorted(cached) == sorted(fresh)
    for k in fresh:
        assert _bits_equal(cached[k], fresh[k]), k
        assert not cached[k].flags.writeable
    out = consts_from_numpy(cached, "cpu")            # copies, no warning
    assert out[k].numpy().flags.writeable


def test_disk_tier_recomputes_a_corrupt_entry(disk_dir):
    stats = tpipe.CONSTS_CACHE_STATS
    cfg = tcfg.tiny_config(variant="dynamic", nz=20)
    fresh = init_pipeline(cfg)
    (path,) = disk_dir.iterdir()
    path.write_bytes(path.read_bytes()[:100])         # a torn file
    tpipe.clear_consts_cache()
    again = init_pipeline(cfg)
    assert (stats.misses, stats.disk_hits) == (2, 0)
    for k in fresh:
        assert _bits_equal(again[k], fresh[k]), k
    tpipe.clear_consts_cache()                        # rewritten whole
    init_pipeline(cfg)
    assert stats.disk_hits == 1


def test_disk_tier_skips_an_entry_over_its_cap(disk_dir, monkeypatch):
    cfg = tcfg.tiny_config(variant="cnn", nz=20)
    size = tpipe._consts_nbytes(init_pipeline(cfg, cache=False))
    monkeypatch.setattr(tpipe, "DISK_CACHE_MAX_BYTES", size - 1)
    init_pipeline(cfg)
    assert list(disk_dir.iterdir()) == []
    assert tpipe.CONSTS_CACHE_STATS.misses == 1
    monkeypatch.setattr(tpipe, "DISK_CACHE_MAX_BYTES", size)
    tpipe.clear_consts_cache()
    init_pipeline(cfg)
    assert len(list(disk_dir.iterdir())) == 1


def test_disk_tier_keys_follow_the_constants_sources(disk_dir, monkeypatch):
    """A file written by a tree whose constant-building sources differ is
    never read: the key carries their digest."""
    stats = tpipe.CONSTS_CACHE_STATS
    cfg = tcfg.tiny_config(variant="dynamic", nz=20)
    init_pipeline(cfg)
    (path,) = disk_dir.iterdir()
    assert f"-{tpipe._sources_digest()}-" in path.name
    monkeypatch.setattr(tpipe, "_sources_digest", lambda: "0" * 12)
    tpipe.clear_consts_cache()
    init_pipeline(cfg)
    assert (stats.misses, stats.disk_hits) == (2, 0)
    assert len(list(disk_dir.iterdir())) == 2
    tpipe.clear_consts_cache(disk=True)               # both are the port's
    assert list(disk_dir.iterdir()) == []


def test_disk_tier_never_reads_the_reference_files(disk_dir):
    """One directory, one config hash in both packages: each reads only
    the files it wrote, and the port's clear leaves the reference's."""
    from repro.core import pipeline as jpipe

    j, t = _pair("tiny", variant="dynamic", nz=20)
    assert tcfg.config_hash(t) == jcfg.config_hash(j)
    jstats = jpipe.CONSTS_CACHE_STATS
    jstats.reset()
    jpipe.init_pipeline(j)
    assert jstats.misses == 1 and len(list(disk_dir.iterdir())) == 1
    init_pipeline(t)
    assert tpipe.CONSTS_CACHE_STATS.misses == 1        # not read
    assert tpipe.CONSTS_CACHE_STATS.disk_hits == 0
    names = sorted(p.name for p in disk_dir.iterdir())
    assert len(names) == 2
    assert names[0].startswith("consts-torch-v1-")
    assert names[1].startswith("consts-v1-")
    jpipe.clear_consts_cache()
    jpipe.init_pipeline(j)
    assert jstats.disk_hits == 1 and jstats.misses == 1
    tpipe.clear_consts_cache(disk=True)
    assert [p.name for p in disk_dir.iterdir()] == names[1:]


def test_cache_bypass_and_settings_match_the_reference(disk_dir):
    from repro.core import pipeline as jpipe

    cfg = tcfg.tiny_config(variant="dynamic", nx=20)
    init_pipeline(cfg, cache=False)
    init_pipeline(cfg, cache=False)
    stats = tpipe.CONSTS_CACHE_STATS
    assert (stats.misses, stats.mem_hits, stats.disk_hits) == (0, 0, 0)
    assert list(disk_dir.iterdir()) == []
    assert tpipe.DISK_CACHE_MAX_BYTES == jpipe.DISK_CACHE_MAX_BYTES
    assert tpipe.MEM_CACHE_MAX_BYTES == jpipe.MEM_CACHE_MAX_BYTES
    tpipe.set_consts_cache_dir(None)                  # disk tier off
    init_pipeline(cfg)
    assert stats.misses == 1 and list(disk_dir.iterdir()) == []
