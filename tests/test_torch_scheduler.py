"""The port's multi-tenant scheduler on the CPU, against the reference.

The determinism oracle of the reference (tests/test_scheduler.py), held
by the port against its own ``monolithic_pipeline_fn``: every frame
served through the coalescing scheduler — batched with other tenants'
frames, zero-padded to the policy shape, dispatched in arrival order,
drained in any order — equals the same frame run alone, bit for bit.
Across the three variants, B-mode and colour Doppler tenants, in-flight
depths 1 / 2 / 3, both drain modes, and a gate that forces completions
out of dispatch order. Each frame is also held to the ROADMAP parity
tolerances of the reference's ``monolithic_pipeline_fn`` on the same RF
(B-mode atol 1.2e-3 with at most 1 % of pixels above 1e-5; Doppler
1e-4).

Also: the stats dict has the reference's keys; `warm_pool` keys equal
the reference scheduler's group keys for the same specs; a warmed
executor's `dispatch_padded` equals the un-warmed one; and the policy
invariants (occupancy <= max_batch, the ring <= in_flight, a lone frame
flushes at the delay bound, stable tie-break, no busy spin).
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import config as jcfg  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.launch import scheduler as jsched  # noqa: E402

from repro_torch.core import (BatchedExecutor, Modality,  # noqa: E402
                              consts_from_numpy, init_pipeline,
                              monolithic_pipeline_fn, tiny_config)
from repro_torch.core.aot import WarmPool, aot_warm, warm_pool  # noqa: E402
from repro_torch.data import synth_rf  # noqa: E402
from repro_torch.launch import scheduler as sched  # noqa: E402
from repro_torch.launch.scheduler import (BatchPolicy, StreamSpec,  # noqa: E402
                                          make_mixed_streams,
                                          serve_multitenant)

SMALL = dict(n_c=16, n_f=8, nz=32, nx=32)
BURST = 1e9          # every frame arrives at t ~ 0
VARIANTS = ("dynamic", "cnn", "sparse")

_PORT = {}
_REF = {}


def _streams(variant, n_clients=3, n_frames=5):
    cfg = tiny_config(variant=variant, **SMALL)
    return make_mixed_streams(n_clients, cfg,
                              cfg.with_(modality=Modality.DOPPLER),
                              base_fps=400.0, n_frames=n_frames)


def _port_oracle(cfg, seed):
    """The frame run alone through the port's monolithic pipeline."""
    key = (cfg, seed)
    if key not in _PORT:
        consts = consts_from_numpy(init_pipeline(cfg), "cpu")
        rf = torch.as_tensor(synth_rf(cfg, seed=seed))[None]
        _PORT[key] = monolithic_pipeline_fn(cfg)(consts, rf)[0].numpy()
    return _PORT[key]


def _ref_image(cfg, seed):
    """The reference's monolithic image of the same frame (JAX, CPU)."""
    key = (cfg, seed)
    if key not in _REF:
        jc = jcfg.tiny_config(variant=jcfg.Variant(cfg.variant.value),
                              modality=jcfg.Modality(cfg.modality.value),
                              **SMALL)
        consts = {k: jnp.asarray(v)
                  for k, v in jpipe.init_pipeline(jc).items()}
        fn = jax.jit(jpipe.monolithic_pipeline_fn(jc))
        _REF[key] = np.asarray(fn(consts,
                                  jnp.asarray(synth_rf(cfg, seed=seed))))
    return _REF[key]


def _check_parity(modality, out, ref):
    assert out.shape == ref.shape and np.isfinite(out).all()
    d = np.abs(out - ref)
    if modality == "bmode":
        assert d.max() <= 1.2e-3, d.max()
        assert (d > 1e-5).mean() <= 0.01, (d > 1e-5).mean()
    else:
        assert d.max() <= 1e-4, d.max()


def _check_oracle(streams, stats):
    for spec in streams:
        outs = stats["outputs"][spec.stream_id]
        assert len(outs) == spec.n_frames
        for k, out in enumerate(outs):
            seed = spec.frame_seed(k)
            assert np.array_equal(out, _port_oracle(spec.cfg, seed)), (
                f"{spec.stream_id}[{k}] differs from the lone frame")
            _check_parity(spec.cfg.modality.value, out,
                          _ref_image(spec.cfg, seed))


@pytest.mark.parametrize("drain", ["async", "block"])
@pytest.mark.parametrize("in_flight", [1, 2, 3])
@pytest.mark.parametrize("variant", VARIANTS)
def test_served_frames_equal_the_lone_frame(variant, in_flight, drain):
    streams = _streams(variant)
    stats = serve_multitenant(
        streams, policy=BatchPolicy(max_batch=4, max_queue_delay_ms=2.0),
        in_flight=in_flight, drain=drain, collect_outputs=True,
        device="cpu")
    _check_oracle(streams, stats)
    assert stats["occupancy"]["max_occupancy"] <= 4
    ifo = stats["in_flight_occupancy"]
    assert ifo["max_depth"] <= in_flight and ifo["in_flight"] == in_flight
    assert stats["drain"] == drain and len(stats["groups"]) == 2
    assert stats["resources"]["energy_joules"] is None


@pytest.mark.parametrize("modality", ["power_doppler", "doppler"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_smoothed_heads_are_batch_invariant(variant, modality):
    """A Doppler frame in a padded batch of 4 equals the frame alone, bit
    for bit: the 3x3 smooth is an ordered shift-and-add (as an
    ``F.conv2d`` it differed in the last bit for power Doppler)."""
    cfg = tiny_config(variant=variant, modality=modality, **SMALL)
    rf = np.stack([synth_rf(cfg, seed=s) for s in range(3)])
    out = BatchedExecutor(cfg, device="cpu").call_padded(rf, 4).numpy()
    for i in range(3):
        assert np.array_equal(out[i], _port_oracle(cfg, i))


def test_out_of_order_drain_leaves_no_trace(monkeypatch):
    """A gate holds the first launched batch back until a later one (of
    the other group) has retired: the drain order differs from the
    dispatch order, and every frame still equals the lone frame."""
    real_ready = sched._ready
    launch_order, keep, retire_order = {}, [], []
    refusals = {"n": 0}

    def gate(p):
        key = id(p)
        if key not in launch_order:
            launch_order[key] = len(launch_order)
            keep.append(p)
        if (launch_order[key] == 0 and not retire_order
                and refusals["n"] < 5000):
            refusals["n"] += 1
            return False
        if not real_ready(p):
            return False
        retire_order.append(launch_order[key])
        return True

    monkeypatch.setattr(sched, "_ready", gate)
    cfg_b = tiny_config(variant="dynamic", **SMALL)
    cfg_d = cfg_b.with_(modality=Modality.DOPPLER)
    streams = [StreamSpec("b", cfg_b, fps=BURST, n_frames=5, seed=3, pool=5),
               StreamSpec("d", cfg_d, fps=BURST, n_frames=4, seed=11,
                          pool=4)]
    stats = serve_multitenant(
        streams, policy=BatchPolicy(max_batch=3, max_queue_delay_ms=2.0),
        in_flight=3, collect_outputs=True, device="cpu")
    assert retire_order[0] != 0, retire_order
    assert sorted(retire_order) == list(range(len(launch_order)))
    _check_oracle(streams, stats)


def _key_tree(d, depth=0):
    """Nested key sets of a stats dict (dict values only)."""
    if not isinstance(d, dict) or depth > 3:
        return None
    return {k: _key_tree(v, depth + 1) for k, v in d.items()}


def test_stats_keys_equal_reference():
    streams = _streams("dynamic", n_clients=2, n_frames=3)
    jc = jcfg.tiny_config(variant=jcfg.Variant.DYNAMIC, **SMALL)
    jstreams = jsched.make_mixed_streams(
        2, jc, jc.with_(modality=jcfg.Modality.DOPPLER), base_fps=400.0,
        n_frames=3)
    policy = dict(max_batch=4, max_queue_delay_ms=2.0)
    got = serve_multitenant(streams, policy=BatchPolicy(**policy),
                            device="cpu")
    want = jsched.serve_multitenant(jstreams,
                                    policy=jsched.BatchPolicy(**policy))
    assert set(got) == set(want)
    for key in ("policy", "latency", "queue_delay", "occupancy",
                "in_flight_occupancy", "acq_per_s_ci"):
        assert _key_tree(got[key]) == _key_tree(want[key]), key
    assert set(got["per_stream"]) == set(want["per_stream"])
    for sid in got["per_stream"]:
        assert _key_tree(got["per_stream"][sid]) == \
            _key_tree(want["per_stream"][sid])
    # the same group hashes, with the reference's per-group keys
    assert set(got["groups"]) == set(want["groups"])
    for gid in got["groups"]:
        g, w = got["groups"][gid], want["groups"][gid]
        assert set(g) == set(w) and set(g["plan"]) == set(w["plan"])
        assert g["plan"]["in_flight"] == w["plan"]["in_flight"] == 2
        assert g["plan"]["warm_start"] == w["plan"]["warm_start"] == "aot"
    assert set(want["resources"]) <= set(got["resources"])
    assert got["trace_sha256"] == want["trace_sha256"]
    assert got["dispatch_order"] and got["name"] == want["name"]


def test_warm_pool_keys_equal_reference_group_keys():
    """The pool keys of the same specs, as the reference's scheduler and
    warm pool key them: (canonical hash of the plan-concretized config,
    pad_to, n_devices, donate)."""
    streams = _streams("dynamic", n_clients=4)
    jc = jcfg.tiny_config(variant=jcfg.Variant.DYNAMIC, **SMALL)
    jstreams = jsched.make_mixed_streams(
        4, jc, jc.with_(modality=jcfg.Modality.DOPPLER), base_fps=400.0,
        n_frames=5)
    groups, _ = jsched._build_groups(jstreams, jsched.BatchPolicy(4, 2.0),
                                     devices=None, plan_policy=None)
    want = {(g.key, 4, 1, g.engine.donate) for g in groups}
    pool = warm_pool(streams, max_batch=4, device="cpu")
    assert set(pool.keys()) == want and len(pool) == 2
    assert pool.warmup_s > 0.0
    before = {k: pool.get(k).engine for k in pool.keys()}
    warm_pool(streams, max_batch=4, device="cpu", pool=pool)
    assert {k: pool.get(k).engine for k in pool.keys()} == before
    stats = serve_multitenant(streams, policy=BatchPolicy(4, 2.0),
                              pool=pool, device="cpu")
    assert stats["warmup_s"] == 0.0
    assert {g["warm_source"] for g in stats["groups"].values()} == {"pool"}


@pytest.mark.parametrize("variant", VARIANTS)
def test_dispatch_padded_after_aot_warm_equals_unwarmed(variant):
    cfg = tiny_config(variant=variant, modality="power_doppler", **SMALL)
    rf = np.stack([synth_rf(cfg, seed=s) for s in range(3)])
    want = BatchedExecutor(cfg, device="cpu").dispatch_padded(rf, 4)
    ex = BatchedExecutor(cfg, device="cpu")
    prog = aot_warm(ex, 4)
    assert prog.compile_s == 0.0 and prog.launches is None
    assert prog.warmup_s > 0.0 and prog.pad_to == 4 and prog.devices == 1
    assert torch.equal(ex.dispatch_padded(rf, 4), want)
    with pytest.raises(ValueError, match="pad_to"):
        aot_warm(ex, 0)


def test_serving_refuses_what_the_port_does_not_do():
    streams = _streams("dynamic", n_clients=1, n_frames=1)
    with pytest.raises(ValueError, match="multiple of n_devices"):
        serve_multitenant(streams, policy=BatchPolicy(3, 5.0),
                          devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="donate"):
        serve_multitenant(streams, donate=True, device="cpu")
    with pytest.raises(ValueError, match="drain"):
        serve_multitenant(streams, drain="later", device="cpu")
    with pytest.raises(ValueError, match="in_flight"):
        serve_multitenant(streams, in_flight=0, device="cpu")
    with pytest.raises(ValueError, match="multiple of n_devices"):
        warm_pool(streams, max_batch=3, devices=["cpu", "cpu"])
    assert isinstance(WarmPool().keys(), tuple)


def test_policy_invariants_on_a_burst():
    """A 10-frame burst under max_batch 4 dispatches as 4 + 4 + 2; at
    in_flight 1 every launch retires before the next; a lone frame
    flushes at the delay bound."""
    cfg = tiny_config(variant="dynamic", **SMALL)
    stats = serve_multitenant(
        [StreamSpec("burst", cfg, fps=BURST, n_frames=10)],
        policy=BatchPolicy(max_batch=4, max_queue_delay_ms=0.0),
        in_flight=1, device="cpu")
    occ, ifo = stats["occupancy"], stats["in_flight_occupancy"]
    assert (occ["batches"], occ["frames"], occ["max_occupancy"]) == (3, 10, 4)
    assert ifo["max_depth"] == 1 and ifo["full_rate"] == 1.0
    stats = serve_multitenant(
        [StreamSpec("solo", cfg, fps=BURST, n_frames=1)],
        policy=BatchPolicy(max_batch=8, max_queue_delay_ms=50.0),
        device="cpu")
    assert 0.05 <= stats["queue_delay"]["p50_s"] < 5.0
    assert stats["occupancy"]["max_occupancy"] == 1


def test_pick_group_tie_break_and_idle_horizon():
    from repro_torch.launch.scheduler import (_Frame, _Group, _idle_horizon,
                                              _pick_group, _poll_grain)

    policy = BatchPolicy(max_batch=4, max_queue_delay_ms=5.0)
    a, b = _Group("a", None, None), _Group("b", None, None)
    a.queue.append(_Frame(stream=0, seq=0, rf=None, t_arrival=1.0))
    b.queue.append(_Frame(stream=1, seq=0, rf=None, t_arrival=1.0))
    assert _pick_group([a, b], 1.006, policy) is a
    assert _pick_group([b, a], 1.006, policy) is b
    assert _pick_group([a], 1.001, policy) is None
    delay = 5e-3
    hz = _idle_horizon([], 0, [a], delay)
    assert hz == 1.0 + delay
    frames = [_Frame(stream=0, seq=0, rf=None, t_arrival=1.5)]
    assert _idle_horizon(frames, 0, [_Group("e", None, None)], delay) == 1.5
    assert _idle_horizon([], 0, [_Group("x", None, None)], delay) is None
    assert _poll_grain(0.0, None, base=2e-4) == 2e-4
    assert _poll_grain(0.0, 1.0, base=2e-4) == sched._POLL_CAP_S
    assert _poll_grain(1.0, 0.5, base=2e-4) == 2e-4


def test_poll_base_env_override(monkeypatch):
    monkeypatch.setenv("REPRO_POLL_S", "0.001")
    assert sched._poll_base() == 0.001
    for bad in ("0", "-1", "fast"):
        monkeypatch.setenv("REPRO_POLL_S", bad)
        assert sched._poll_base() == sched._POLL_S


def test_spec_and_policy_validation_match_reference():
    cfg = tiny_config(variant="dynamic", **SMALL)
    jc = jcfg.tiny_config(variant=jcfg.Variant.DYNAMIC, **SMALL)
    bad_specs = [dict(fps=0.0), dict(n_frames=0), dict(pool=0),
                 dict(start_s=-1.0), dict(start_s=1.0, stop_s=0.5)]
    for kw in bad_specs:
        with pytest.raises(ValueError):
            StreamSpec("s", cfg, **kw)
        with pytest.raises(ValueError):
            jsched.StreamSpec("s", jc, **kw)
    for kw in (dict(max_batch=0), dict(max_queue_delay_ms=-1.0)):
        with pytest.raises(ValueError):
            BatchPolicy(**kw)
    spec = StreamSpec("s", cfg, fps=50.0, n_frames=9, pool=4, seed=5)
    jspec = jsched.StreamSpec("s", jc, fps=50.0, n_frames=9, pool=4, seed=5)
    assert [spec.frame_seed(k) for k in range(9)] == \
        [jspec.frame_seed(k) for k in range(9)]
    assert [spec.arrival_s(k) for k in range(9)] == \
        [jspec.arrival_s(k) for k in range(9)]


def test_multitenant_cli_on_the_cpu(monkeypatch, capsys):
    from repro_torch.launch import serve

    monkeypatch.setattr("sys.argv", [
        "serve", "--ultrasound", "--multitenant", "--device", "cpu",
        "--clients", "2", "--frames", "2", "--queue-delay-ms", "1",
        "--drain", "block", "--in-flight", "1"])
    serve.main()
    out = capsys.readouterr().out
    assert "multitenant/2streams/2groups/b4q1if1/block/steady: 4 " \
        "acquisitions" in out
    assert "energy=not measured" in out and "process_rss_sampled" in out
