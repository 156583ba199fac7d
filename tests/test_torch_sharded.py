"""The port's sharded executor and sharded serving on the CPU.

A device may appear more than once, so ``["cpu", "cpu"]`` runs the split
on this one-device machine: `ShardedExecutor` over one and two CPU
shards, batches of 1, 4 and 5 (the last padded to 6), equals
`BatchedExecutor` bit for bit for the three variants, and the reference's
``monolithic_pipeline_fn`` within the ROADMAP's parity tolerances
(B-mode atol 1.2e-3 with at most 1 % of pixels above 1e-5). The plan
stamp names the topology as the reference's does; the sharded stream's
stats have the reference's keys; the scheduler over two shards refuses a
``max_batch`` that does not split, and every frame it serves equals the
lone frame bit for bit.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import ShardedExecutor as JShardedExecutor  # noqa: E402
from repro.core import config as jcfg  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402

from repro_torch.core import (BatchedExecutor, Modality,  # noqa: E402
                              ShardedExecutor, consts_from_numpy,
                              init_pipeline, monolithic_pipeline_fn,
                              tiny_config)
from repro_torch.core.aot import warm_pool  # noqa: E402
from repro_torch.data import synth_rf  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.scheduler import (BatchPolicy,  # noqa: E402
                                          make_mixed_streams,
                                          serve_multitenant)

SMALL = dict(n_c=16, n_f=8, nz=32, nx=32)
BURST = 1e9          # every frame arrives at t ~ 0


def _ref_images(variant, rf):
    jc = jcfg.tiny_config(variant=jcfg.Variant(variant))
    consts = {k: jnp.asarray(v) for k, v in jpipe.init_pipeline(jc).items()}
    fn = jax.jit(jpipe.monolithic_pipeline_fn(jc))
    return np.stack([np.asarray(fn(consts, jnp.asarray(r))) for r in rf])


@pytest.mark.parametrize("n_shards", [1, 2])
@pytest.mark.parametrize("variant", ["dynamic", "cnn", "sparse"])
def test_sharded_equals_batched_and_the_reference(variant, n_shards):
    cfg = tiny_config(variant=variant)
    rf = np.stack([synth_rf(cfg, seed=s) for s in range(5)])
    ref = _ref_images(variant, rf)
    eng = ShardedExecutor(cfg, devices=["cpu"] * n_shards)
    batched = BatchedExecutor(cfg, device="cpu")
    assert eng.n_devices == n_shards and eng.plan.devices == n_shards
    for b in (1, 4, 5):
        out = eng(rf[:b])
        assert out.shape[0] == b
        assert torch.equal(out, batched(rf[:b])), b
        d = np.abs(out.numpy() - ref[:b])
        assert d.max() <= 1.2e-3 and (d > 1e-5).mean() <= 0.01, b


def test_dispatch_returns_one_contiguous_shard_a_device():
    cfg = tiny_config()
    rf = np.stack([synth_rf(cfg, seed=s) for s in range(4)])
    eng = ShardedExecutor(cfg, devices=["cpu", "cpu"])
    shards = eng.dispatch(rf)
    assert [s.shape[0] for s in shards] == [2, 2]
    assert all(s.done_event is None for s in shards)
    want = BatchedExecutor(cfg, device="cpu")(rf)
    assert torch.equal(eng.gather(shards), want)
    assert torch.equal(shards[1], want[2:])
    assert eng.shards[0].consts is eng.shards[1].consts   # one copy
    with pytest.raises(ValueError, match="multiple"):
        eng.dispatch(rf[:3])
    with pytest.raises(ValueError, match="multiple"):
        eng.dispatch_padded(rf[:3], 3)
    assert torch.equal(eng.call_padded(rf[:3], 4), want[:3])


def test_sharded_executor_refuses_what_it_cannot_run():
    with pytest.raises(ValueError, match="at least one"):
        ShardedExecutor(tiny_config(), devices=())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ShardedExecutor(tiny_config())        # never picks the CPU
    with pytest.raises(ValueError):
        ShardedExecutor(tiny_config(), devices=["cpu", "meta"])


@pytest.mark.parametrize("n_shards", [1, 2])
def test_plan_stamp_names_the_topology_like_the_reference(n_shards):
    ref = JShardedExecutor(jcfg.tiny_config()).plan
    if n_shards != 1:
        ref = ref.with_devices(n_shards, (("data", n_shards),))
    out = ShardedExecutor(tiny_config(), devices=["cpu"] * n_shards).plan
    r, o = ref.json_dict(), out.json_dict()
    assert sorted(o) == sorted(r)
    assert (o["devices"], o["mesh_shape"]) == (r["devices"],
                                               r["mesh_shape"])
    assert BatchedExecutor(tiny_config(), device="cpu").plan.json_dict()[
        "mesh_shape"] is None
    assert ShardedExecutor(tiny_config(), devices=["cpu"] * n_shards
                           ).name.endswith(f":d{n_shards}")


def test_sharded_stream_stats_have_the_reference_keys():
    ref = jserve.serve_ultrasound_sharded(
        jcfg.tiny_config(), batch_per_device=2, n_batches=2, depth=2)
    out = serve.serve_ultrasound_sharded(
        tiny_config(), batch_per_device=2, n_batches=3, depth=2,
        devices=["cpu", "cpu"])
    assert sorted(out) == sorted(ref)
    assert out["devices"] == 2 and out["batch"] == 4
    assert out["plan"]["devices"] == 2
    assert out["plan"]["mesh_shape"] == [["data", 2]]
    assert out["acquisitions"] == 12
    assert sorted(v["n"] for v in out["per_device_latency"].values()) \
        == [3, 3]
    assert out["speedup_vs_single"] == pytest.approx(
        out["scale_efficiency"] * 2)
    assert out["baseline_fps"] > 0
    assert out["resources"]["energy_joules"] is None


def _lone(cfg, seed):
    consts = consts_from_numpy(init_pipeline(cfg), "cpu")
    rf = torch.as_tensor(synth_rf(cfg, seed=seed))[None]
    return monolithic_pipeline_fn(cfg)(consts, rf)[0].numpy()


@pytest.mark.parametrize("variant", ["dynamic", "sparse"])
def test_scheduler_over_two_shards_serves_the_lone_frame(variant):
    cfg = tiny_config(variant=variant, **SMALL)
    streams = make_mixed_streams(3, cfg, cfg.with_(modality=Modality.DOPPLER),
                                 base_fps=BURST, n_frames=5)
    devices = ["cpu", "cpu"]
    with pytest.raises(ValueError, match="multiple of n_devices"):
        serve_multitenant(streams, policy=BatchPolicy(3, 2.0),
                          devices=devices)
    pool = warm_pool(streams, max_batch=4, devices=devices)
    assert {k[2] for k in pool.keys()} == {2} and len(pool) == 2
    st = serve_multitenant(streams, policy=BatchPolicy(4, 2.0), pool=pool,
                           devices=devices, collect_outputs=True)
    assert all(g["plan"]["devices"] == 2 and g["warm_source"] == "pool"
               for g in st["groups"].values())
    assert st["occupancy"]["max_occupancy"] <= 4
    for spec in streams:
        for k, out in enumerate(st["outputs"][spec.stream_id]):
            assert np.array_equal(out, _lone(spec.cfg, spec.frame_seed(k)))


def test_cli_runs_sharded_and_autotuned_on_cpu(capsys, monkeypatch):
    monkeypatch.setattr("sys.argv", [
        "serve", "--ultrasound", "--device", "cpu", "--devices", "2",
        "--plan", "autotune", "--variant", "auto", "--batch", "1",
        "--batches", "2"])
    serve.main()
    out = capsys.readouterr().out
    assert "policy=autotune" in out and "/b1xd2" in out
    assert "sharded over 2 device(s)" in out
