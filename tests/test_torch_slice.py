"""The PyTorch port's serving path on the CPU, against the JAX reference.

``UltrasoundPipeline`` and ``BatchedExecutor(device="cpu")`` against the
reference's ``monolithic_pipeline_fn`` on the same seeded RF and the
reference's own constants: the dynamic variant for B-mode and power
Doppler, each per stage (``fusion="none"``) and fused, and colour Doppler;
the cnn and sparse variants per stage for all three modalities.

Tolerances (image level):
  * B-mode: atol 1.2e-3 with at most 1 % of pixels above 1e-5.
    ``ln_approx`` takes 16 nested square roots and scales ``y - 1`` by
    2^16; one float32 ulp of ``y`` just below 1 is 2^-24 * 2^16 *
    20/ln10 / 60 dB = 5.66e-4 in the image, and a correct port may land
    one such step away where the envelope differs in its last bit
    (channel-sum order). Two steps are allowed. With the correctly
    rounded sqrt (``cnn_ops.sqrt_rn``) the measured max|d| here is
    1.2e-7.
  * Power Doppler: atol 1e-4 (the same step is 10/ln10 / 60 / 9 =
    3.1e-5 after the 3x3 box smooth; measured max 3.15e-5).
  * Colour Doppler: atol 1e-4. The phase atan2(Im R1, Re R1) of pixels
    where |R1| is small follows the last bits of the channel and frame
    sums; measured max 2.8e-5 at (n_c=16, n_f=8, 32x32).

Measured for cnn / sparse at that size: B-mode 5.65e-4 on one pixel of
16,384 (one ``ln_approx`` step), power Doppler 1.8e-7, colour Doppler
2.9e-5 / 1.9e-5.
"""

import numpy as np
import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.bench.schema import RECORD_KEYS, validate_record  # noqa: E402
from repro.core import config as jcfg  # noqa: E402
from repro.core import pipeline as jpipe  # noqa: E402
from repro.data import synth_rf  # noqa: E402

from repro_torch import kernels  # noqa: E402
from repro_torch.core import (BatchedExecutor, UltrasoundPipeline,  # noqa: E402
                              init_pipeline, monolithic_pipeline_fn,
                              plan_pipeline, resolve_device, tiny_config)
from repro_torch.core.pipeline import consts_from_numpy  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

WIDE = dict(n_c=16, n_f=8, nz=32, nx=32)
SEEDS = (0, 9)


def _check_image(modality, out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape and np.isfinite(out).all()
    d = np.abs(out - ref)
    if modality == "bmode":
        assert d.max() <= 1.2e-3, d.max()
        assert (d > 1e-5).mean() <= 0.01, (d > 1e-5).mean()
    else:
        assert d.max() <= 1e-4, d.max()


def _reference_images(variant, modality):
    """JAX monolithic images of one (variant, modality) on seeded RF."""
    jc = jcfg.tiny_config(variant=jcfg.Variant(variant),
                          modality=jcfg.Modality(modality), **WIDE)
    consts = jpipe.init_pipeline(jc)
    fn = jax.jit(jpipe.monolithic_pipeline_fn(jc))
    rf = np.stack([synth_rf(jc, seed=s) for s in SEEDS])
    jconsts = {k: jnp.asarray(v) for k, v in consts.items()}
    return rf, np.stack([np.asarray(fn(jconsts, jnp.asarray(r)))
                         for r in rf])


@pytest.fixture(scope="module")
def refs():
    """JAX monolithic images for each modality, dynamic variant."""
    return {m: _reference_images("dynamic", m)
            for m in ("bmode", "power_doppler", "doppler")}


@pytest.fixture(scope="module")
def operator_refs():
    """The same for the cnn and sparse variants, built on first use."""
    cache = {}

    def get(variant, modality):
        if (variant, modality) not in cache:
            cache[variant, modality] = _reference_images(variant, modality)
        return cache[variant, modality]
    return get


@pytest.mark.parametrize("fusion", ["none", "fused"])
@pytest.mark.parametrize("modality", ["bmode", "power_doppler"])
def test_executor_matches_reference(refs, modality, fusion):
    rf, ref = refs[modality]
    cfg = tiny_config(variant="dynamic", modality=modality, fusion=fusion,
                      **WIDE)
    ex = BatchedExecutor(cfg, device="cpu")
    assert ex.plan.backend == "cpu"
    lowering = "pallas" if fusion == "fused" else "xla"
    assert dict(ex.plan.stage_lowerings)["beamform"] == lowering
    _check_image(modality, ex(rf), ref)


@pytest.mark.parametrize("fusion", ["none", "fused"])
@pytest.mark.parametrize("modality", ["bmode", "power_doppler"])
def test_pipeline_matches_reference(refs, modality, fusion):
    rf, ref = refs[modality]
    cfg = tiny_config(variant="dynamic", modality=modality, fusion=fusion,
                      **WIDE)
    pipe = UltrasoundPipeline(cfg, device="cpu")
    _check_image(modality, pipe(rf[1]), ref[1])


def test_color_doppler_matches_reference(refs):
    rf, ref = refs["doppler"]
    cfg = tiny_config(variant="dynamic", modality="doppler", **WIDE)
    out = BatchedExecutor(cfg, device="cpu")(rf)
    assert np.abs(np.asarray(out) - ref).max() <= 1e-4


OPERATOR_CELLS = [(v, m) for v in ("cnn", "sparse")
                  for m in ("bmode", "power_doppler", "doppler")]


@pytest.mark.parametrize("variant,modality", OPERATOR_CELLS)
def test_operator_variant_executor_matches_reference(operator_refs, variant,
                                                     modality):
    rf, ref = operator_refs(variant, modality)
    cfg = tiny_config(variant=variant, modality=modality, **WIDE)
    ex = BatchedExecutor(cfg, device="cpu")
    assert dict(ex.plan.stage_lowerings)["beamform"] == "xla"
    _check_image(modality, ex(rf), ref)


@pytest.mark.parametrize("variant,modality", OPERATOR_CELLS)
def test_operator_variant_pipeline_matches_reference(operator_refs, variant,
                                                     modality):
    rf, ref = operator_refs(variant, modality)
    cfg = tiny_config(variant=variant, modality=modality, **WIDE)
    pipe = UltrasoundPipeline(cfg, device="cpu")
    _check_image(modality, pipe(rf[0]), ref[0])


@pytest.mark.parametrize("variant", ["cnn", "sparse"])
def test_operator_variant_kernel_lowering_matches_reference(operator_refs,
                                                            variant):
    """The ``pallas`` beamform pinned on the CPU (the wrapper's plain
    version) gives the reference's image too."""
    rf, ref = operator_refs(variant, "power_doppler")
    cfg = tiny_config(variant=variant, modality="power_doppler",
                      stage_lowerings={"beamform": "pallas"}, **WIDE)
    if variant == "cnn":
        with pytest.raises(ValueError, match="no such lowering"):
            BatchedExecutor(cfg, device="cpu")
        return
    _check_image("power_doppler", BatchedExecutor(cfg, device="cpu")(rf),
                 ref)


def test_monolithic_oracle_dispatches_on_variant(operator_refs):
    """The port's oracle runs each variant's own beamform."""
    rf, ref = operator_refs("sparse", "bmode")
    cfg = tiny_config(variant="sparse", **WIDE)
    consts = consts_from_numpy(init_pipeline(cfg), "cpu")
    assert "bsr_blocks" in consts and "idx" not in consts
    _check_image("bmode", monolithic_pipeline_fn(cfg)(
        consts, torch.as_tensor(rf)), ref)


def test_pipeline_on_reference_consts_matches_own(refs):
    """consts_from_numpy on the reference's constants runs the port
    exactly as its own init_pipeline does."""
    rf, _ = refs["bmode"]
    cfg = tiny_config(variant="dynamic", **WIDE)
    pipe = UltrasoundPipeline(cfg, device="cpu")
    jc = jcfg.tiny_config(variant=jcfg.Variant.DYNAMIC, **WIDE)
    theirs = consts_from_numpy(jpipe.init_pipeline(jc), "cpu")
    x = torch.as_tensor(rf)
    assert torch.equal(pipe._fn(theirs, x), pipe._fn(pipe.consts, x))


@pytest.mark.parametrize("modality,fusion", [("bmode", "none"),
                                             ("power_doppler", "fused")])
def test_padded_batch_equals_single_acquisitions(modality, fusion):
    """Three different RFs padded to four through call_padded give the
    three single-acquisition images: normalization is per acquisition,
    never across the batch (or its zero pad row)."""
    cfg = tiny_config(variant="dynamic", modality=modality, fusion=fusion)
    rf = np.stack([synth_rf(cfg, seed=s) for s in (1, 2, 3)])
    rf[2] //= 7                               # a much quieter acquisition
    ex = BatchedExecutor(cfg, device="cpu")
    out = ex.call_padded(rf, pad_to=4)
    assert out.shape[0] == 3
    for i in range(3):
        single = ex(rf[i:i + 1])[0]
        np.testing.assert_allclose(out[i], single, rtol=0, atol=1e-6)


@pytest.mark.parametrize("modality", ["bmode", "power_doppler"])
def test_sparse_padded_batch_equals_single_acquisitions(modality):
    cfg = tiny_config(variant="sparse", modality=modality)
    rf = np.stack([synth_rf(cfg, seed=s) for s in (1, 2, 3)])
    rf[2] //= 7
    ex = BatchedExecutor(cfg, device="cpu")
    out = ex.call_padded(rf, pad_to=4)
    assert out.shape[0] == 3
    for i in range(3):
        np.testing.assert_allclose(out[i], ex(rf[i:i + 1])[0], rtol=0,
                                   atol=1e-6)


def test_exec_map_map_equals_vmap():
    cfg = tiny_config(variant="dynamic")
    rf = np.stack([synth_rf(cfg, seed=s) for s in (1, 2)])
    a = BatchedExecutor(cfg, device="cpu")(rf)
    b = BatchedExecutor(cfg.with_(exec_map="map"), device="cpu")(rf)
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_cpu_run_launches_no_kernel():
    kernels.reset_launch_counts()
    for modality in ("bmode", "power_doppler"):
        cfg = tiny_config(variant="dynamic", modality=modality,
                          fusion="fused")
        BatchedExecutor(cfg, device="cpu")(synth_rf(cfg)[None])
        cfg = tiny_config(variant="sparse", modality=modality,
                          stage_lowerings={"beamform": "pallas"})
        BatchedExecutor(cfg, device="cpu")(synth_rf(cfg)[None])
    assert set(kernels.launch_counts().values()) == {0}


def test_entry_points_need_cuda_unless_cpu_requested(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tiny_config(variant="dynamic")
    for make in (lambda: BatchedExecutor(cfg),
                 lambda: UltrasoundPipeline(cfg),
                 lambda: BatchedExecutor(cfg, device="cuda"),
                 lambda: serve.serve_ultrasound_stream(cfg, n_batches=1),
                 lambda: resolve_device(None)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_serve_stream_cpu_stats_pass_reference_schema():
    cfg = tiny_config(variant="dynamic")
    stats = serve.serve_ultrasound_stream(cfg, batch=2, n_batches=3,
                                          depth=2, pool=2, device="cpu",
                                          deadline_s=1.0)
    assert set(stats) == set(RECORD_KEYS["stream"])
    rec = dict(stats, kind="stream", latency=stats["latency"].json_dict())
    assert validate_record(rec) == "stream"
    assert stats["acquisitions"] == 6 and stats["latency"].n == 3
    assert stats["plan"]["backend"] == "cpu"
    assert stats["resources"]["peak_memory_bytes"] is None  # not measured
    assert stats["resources"]["energy_joules"] is None


def test_cuda_plan_resolves_kernels():
    """On the card the dynamic beamform is the Hopper kernel, fused spans
    claim every stage, and the stamp says cuda (no device needed)."""
    cfg = tiny_config(variant="dynamic")
    plan = plan_pipeline(cfg, backend="cuda")
    assert dict(plan.stage_lowerings) == {
        "demod": "xla", "beamform": "pallas", "bmode": "xla"}
    js = plan.json_dict()
    assert js["backend"] == "cuda"
    validate_record({"kind": "stage", "name": "x", "stage": "beamform",
                     "plan": js, "n": 1, "mean_s": 1.0, "std_s": 0.0,
                     "p50_s": 1.0, "p95_s": 1.0, "p99_s": 1.0,
                     "jitter_s": 0.0, "budget_s": None, "miss_rate": 0.0})
    fused = plan_pipeline(cfg.with_(modality="power_doppler",
                                    fusion="fused", precision="bf16"),
                          backend="cuda")
    assert set(dict(fused.stage_lowerings).values()) == {"pallas"}
    assert fused.json_dict()["fusion_group"] == \
        "demod+beamform+power_doppler"
    auto = plan_pipeline(cfg.with_(variant="auto"), "heuristic",
                         backend="cuda")
    assert auto.variant.value == "dynamic"
    assert auto.provenance == "heuristic:cuda->dynamic"


def test_cuda_plan_operator_variants():
    """On the card the sparse beamform is the Hopper BSR kernel and the
    cnn beamform the plain matrix product; AUTO stays dynamic. A block
    structure the kernel cannot take still plans the kernel, which then
    raises (tests/test_torch_gpu.py): the plan never routes around it."""
    for variant, lowering in (("sparse", "pallas"), ("cnn", "xla")):
        for modality in ("bmode", "power_doppler", "doppler"):
            plan = plan_pipeline(tiny_config(variant=variant,
                                             modality=modality),
                                 backend="cuda")
            assert dict(plan.stage_lowerings) == {
                "demod": "xla", "beamform": lowering, modality: "xla"}
        cpu = plan_pipeline(tiny_config(variant=variant), backend="cpu")
        assert dict(cpu.stage_lowerings)["beamform"] == "xla"
    big_blocks = tiny_config(variant="sparse", sparse_block_s=512)
    assert dict(plan_pipeline(big_blocks, backend="cuda")
                .stage_lowerings)["beamform"] == "pallas"


@pytest.mark.parametrize("modality", ["bmode", "power_doppler"])
@pytest.mark.parametrize("fusion_block", [64, 128, 256])
def test_fusion_block_matches_reference_fused(modality, fusion_block):
    """A fusion_block the CUDA kernel takes plans its fused lowering on
    the card, stamps the block in the plan, and on the CPU matches the
    reference's fused pipeline at the same block (interpret mode). The
    plain version does not tile, so only the reference's tiling varies."""
    jc = jcfg.tiny_config(variant=jcfg.Variant.DYNAMIC,
                          modality=jcfg.Modality(modality), fusion="fused",
                          fusion_block=fusion_block, **WIDE)
    rf = synth_rf(jc, seed=SEEDS[0])
    ref = np.asarray(jpipe.UltrasoundPipeline(jc)(jnp.asarray(rf)))
    cfg = tiny_config(variant="dynamic", modality=modality, fusion="fused",
                      fusion_block=fusion_block, **WIDE)
    card = plan_pipeline(cfg, backend="cuda")
    assert set(dict(card.stage_lowerings).values()) == {"pallas"}
    assert card.json_dict()["fusion_block"] == fusion_block
    pipe = UltrasoundPipeline(cfg, device="cpu")
    assert dict(pipe.plan.stage_lowerings)["beamform"] == "pallas"
    _check_image(modality, pipe(rf), ref)


@pytest.mark.parametrize("kw,match", [
    (dict(variant="cnn", fusion="fused"), "no fused lowering is registered"),
    (dict(variant="auto"), "cannot resolve"),
    (dict(variant="dynamic", modality="doppler", fusion="fused"),
     "no fused lowering is registered"),
    (dict(variant="dynamic", fusion="fused", fusion_block=100),
     "not available"),
    (dict(variant="dynamic", precision="bf16"), "no available lowering"),
    (dict(variant="dynamic", fusion="fused",
          stage_lowerings={"beamform": "xla"}), "claims"),
    (dict(variant="sparse", modality="power_doppler", fusion="fused"),
     "no fused lowering is registered"),
])
def test_plan_refuses_loudly(kw, match):
    with pytest.raises(ValueError, match=match):
        plan_pipeline(tiny_config(**kw), backend="cuda")


def test_serve_cli_on_cpu(monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", ["serve", "--ultrasound", "--device",
                                     "cpu", "--batches", "2", "--batch",
                                     "1"])
    serve.main()
    out = capsys.readouterr().out
    assert "backend=cpu" in out and "energy=not measured" in out


@pytest.mark.parametrize("variant", ["cnn", "sparse"])
def test_serve_cli_operator_variants_on_cpu(monkeypatch, capsys, variant):
    monkeypatch.setattr("sys.argv", ["serve", "--ultrasound", "--variant",
                                     variant, "--device", "cpu",
                                     "--batches", "2", "--batch", "2"])
    serve.main()
    out = capsys.readouterr().out
    assert f"variant={variant}" in out and f"/{variant}/b2" in out
