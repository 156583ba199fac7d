"""The port's trace layer against the reference's (repro.data.traces).

Both packages must replay the same load: for every profile,
`generate_trace` gives the same arrival floats (exactly), the same
connect windows and the same ``trace_sha256``; the committed fixture
loads to equal traces; and each contract violation raises the error of
the same name in both.
"""

import os

import pytest

pytest.importorskip("torch")

from repro.data import traces as jtr  # noqa: E402
from repro.launch import scheduler as jsched  # noqa: E402
from repro.core import config as jcfg  # noqa: E402

from repro_torch.core import Modality, tiny_config  # noqa: E402
from repro_torch.data import traces as ttr  # noqa: E402
from repro_torch.launch import scheduler as tsched  # noqa: E402

FIXTURE = os.path.join(os.path.dirname(__file__), "traces",
                       "burst_tiny.json")
FIXTURE_SHA = ("202704d3f54ff3642a327d52d9b87df7"
               "e6415037fd84498742c6cdf2ccc282d0")


def _same_trace(a, b):
    assert len(a.streams) == len(b.streams)
    for sa, sb in zip(a.streams, b.streams):
        assert sa.stream_id == sb.stream_id
        assert sa.arrivals == sb.arrivals          # exact floats
        assert (sa.fps, sa.start_s, sa.stop_s) == (sb.fps, sb.start_s,
                                                   sb.stop_s)
    assert (a.profile, a.seed) == (b.profile, b.seed)
    assert a.sha256() == b.sha256()


def test_profiles_match():
    assert ttr.PROFILES == jtr.PROFILES
    assert ttr.TRACE_SCHEMA == jtr.TRACE_SCHEMA


@pytest.mark.parametrize("profile", jtr.PROFILES)
@pytest.mark.parametrize("kw", [
    dict(), dict(n_streams=3, n_frames=7, base_fps=90.0, seed=5),
    dict(n_streams=1, n_frames=1)])
def test_generate_trace_equals_reference(profile, kw):
    _same_trace(ttr.generate_trace(profile, **kw),
                jtr.generate_trace(profile, **kw))


def test_fixture_loads_equal(tmp_path):
    got, want = ttr.load_trace(FIXTURE), jtr.load_trace(FIXTURE)
    _same_trace(got, want)
    assert got.sha256() == FIXTURE_SHA
    path = tmp_path / "t.json"
    got.save(str(path))                         # save -> load fixed point
    _same_trace(ttr.load_trace(str(path)), want)
    assert jtr.load_trace(str(path)).sha256() == FIXTURE_SHA


def test_seed_space_and_mixed_schedule_equal():
    for parts in (("trace", 0, "burst", 3), ("stream", 17, "probe1", 2)):
        assert ttr.seed_space(*parts) == jtr.seed_space(*parts)
    for i in range(5):
        assert ttr.mixed_rate(i, 120.0) == jtr.mixed_rate(i, 120.0)
        assert ttr.mixed_phase(i, 120.0) == jtr.mixed_phase(i, 120.0)


def test_uniform_streams_replay_the_steady_trace():
    """``make_mixed_streams``' uniform schedule is the steady trace, in
    both packages: one ``trace_sha256`` for all four."""
    cfg = tiny_config()
    jc = jcfg.tiny_config()
    port = tsched.trace_of_streams(tsched.make_mixed_streams(
        4, cfg, cfg.with_(modality=Modality.DOPPLER), n_frames=16))
    ref = jsched.trace_of_streams(jsched.make_mixed_streams(
        4, jc, jc.with_(modality=jcfg.Modality.DOPPLER), n_frames=16))
    steady = ttr.generate_trace("steady", n_streams=4, n_frames=16)
    assert port.sha256() == ref.sha256() == steady.sha256() \
        == jtr.generate_trace("steady", n_streams=4, n_frames=16).sha256()
    # replayed through TraceArrival: the same specs' arrivals
    replay = tsched.make_trace_streams(
        ttr.generate_trace("burst", n_streams=4, n_frames=8), cfg,
        cfg.with_(modality=Modality.DOPPLER))
    jreplay = jsched.make_trace_streams(
        jtr.generate_trace("burst", n_streams=4, n_frames=8), jc,
        jc.with_(modality=jcfg.Modality.DOPPLER))
    for a, b in zip(replay, jreplay):
        assert [a.arrival_s(k) for k in range(a.n_frames)] == \
            [b.arrival_s(k) for k in range(b.n_frames)]
        assert [a.frame_seed(k) for k in range(a.n_frames)] == \
            [b.frame_seed(k) for k in range(b.n_frames)]


def _bad_stream(mod, **kw):
    args = dict(stream_id="p", arrivals=(0.0, 0.1), fps=10.0)
    args.update(kw)
    return mod.StreamTrace(**args)


ERROR_CASES = {
    "no arrivals": lambda m: _bad_stream(m, arrivals=()),
    "empty id": lambda m: _bad_stream(m, stream_id=""),
    "fps 0": lambda m: _bad_stream(m, fps=0.0),
    "negative arrival": lambda m: _bad_stream(m, arrivals=(-1.0, 0.0)),
    "decreasing": lambda m: _bad_stream(m, arrivals=(0.2, 0.1)),
    "negative start": lambda m: _bad_stream(m, start_s=-0.5),
    "stop before start": lambda m: _bad_stream(m, start_s=0.5, stop_s=0.1),
    "no streams": lambda m: m.Trace(streams=()),
    "duplicate ids": lambda m: m.Trace(streams=(_bad_stream(m),
                                                _bad_stream(m))),
    "unknown profile": lambda m: m.generate_trace("poisson"),
    "no streams asked": lambda m: m.generate_trace("steady", n_streams=0),
    "no frames asked": lambda m: m.generate_trace("steady", n_frames=0),
    "base_fps 0": lambda m: m.generate_trace("burst", base_fps=0.0),
    "uniform fps 0": lambda m: m.UniformArrival(fps=0.0),
    "empty replay": lambda m: m.TraceArrival(()),
}


@pytest.mark.parametrize("case", sorted(ERROR_CASES))
def test_error_types_match(case):
    make = ERROR_CASES[case]
    with pytest.raises(jtr.TraceError) as ref:
        make(jtr)
    with pytest.raises(ttr.TraceError) as got:
        make(ttr)
    assert type(got.value).__name__ == type(ref.value).__name__
    assert isinstance(got.value, ValueError)


@pytest.mark.parametrize("doc", ['{"schema": "other", "streams": []}',
                                 '{"schema": "repro-trace-v1"}',
                                 '{"schema": "repro-trace-v1", '
                                 '"streams": []}'])
def test_load_errors_match(tmp_path, doc):
    path = tmp_path / "bad.json"
    path.write_text(doc)
    with pytest.raises(jtr.TraceError) as ref:
        jtr.load_trace(str(path))
    with pytest.raises(ttr.TraceError) as got:
        ttr.load_trace(str(path))
    assert type(got.value).__name__ == type(ref.value).__name__
