"""The R3M cell ``lmp_r3m_k16_b64`` (configuration ``play_lmp_r3m_calvin``).

On the CPU, at tiny widths: the harness's own run of the R3M
configuration agrees with its reference, step by step, and its control
trains every leaf the reference trains; the operation count agrees with
``FlopCounterMode`` on the reference, and its ``backbone`` class with a
hand count of ResNet-18 at 224x224 (1.82 G multiply-adds a frame); the
seed's backbone weights keep the pooled features' RMS between 0.1 and 10
at every stage; a program whose BatchNorm leaves out its running mean,
its running variance, its gain, its shift or all of them comes out not
correct; the device-span reader pairs the marker kernels of a trace.

On the card (``python3 -m pytest perfbench/tests -m chip``), at the cell's
sizes: the jitter kernel at (1024, 3, 224, 224) against its plain version;
a sound run of ``lmp_r3m_k16_b64`` is correct, and the control (float8
operands in the trunk) and each BatchNorm fault are not; the backbone's time that
graph replays read from the device span agrees within 10 % with its
kernels' time in eager traced steps."""

import contextlib
import copy
import importlib
import time

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench import compare, data, device_spans, harness, readings, trace
from perfbench.tests import tiny

SIZES = {**tiny.SIZES, "augment": dict(tiny.SIZES["augment"], size=[32, 32]),
         "backbone_widths": [8, 16, 32, 64], "backbone_blocks": [2, 2, 2, 2], "backbone_features": 64}
ENCODER = "module.perceptual_encoder.networks.rgb_static"
OVERRIDES = [o for o in tiny.OVERRIDES if not o.startswith((ENCODER, f"+{ENCODER}", "transforms.rgb_static.size"))]
OVERRIDES += [f"{ENCODER}.latent_dim=16", f"{ENCODER}.hidden_dim=32", f"+{ENCODER}.width=8",
              f"+{ENCODER}.compute_dtype=float32", "transforms.rgb_static.size=[32,32]"]


def r3m_cell(**workload_changes):
    """(workload, configuration) of ``lmp_r3m_k16_b64``, cut to a backbone
    of width 8 on 32x32 frames and the tiny Play-LMP widths."""
    workload, config = harness.cell("lmp_r3m_k16_b64")
    workload, config = copy.deepcopy(workload), copy.deepcopy(config)
    config["sizes"] = {**config["sizes"], **SIZES}
    config["dataset"] = dict(tiny.DATASET)
    config["overrides"] = list(config["overrides"]) + OVERRIDES
    config["kernels"] = {"jitter_normalize": [[8 * 8, 3, 32, 32]]}
    workload.update({"batch_size": 8, "warm_chunks": 4, "trace_chunks": 3, **workload_changes})
    return workload, config


def test_the_harness_run_agrees_with_the_reference(tiny_store):
    workload, config = r3m_cell()
    config["limits"] = {k: 1e-4 for k in config["limits"]}
    r = harness.run("lmp_r3m_k16_b64", 20221018, 0.2, False, time.perf_counter(), device="cpu",
                    workload=workload, config=config, data_cache=tiny_store, metrics=[], evidence=True)
    assert r["correct"], r["checks"]
    program, ref, start = r["evidence"]["program"], r["evidence"]["reference"], r["evidence"]["start"]
    for k, values in ref["losses"].items():
        scale = float(values.abs().max())
        for i, v in enumerate(values):
            assert float(program["losses"][i + 1][k]) == pytest.approx(float(v), abs=1e-5 * scale), (k, i)
    assert set(program["moments"]) == set(ref["grads"])
    assert not any(n.startswith("perceptual_encoder.networks.rgb_static.backbone.") for n in ref["grads"])
    for n, g in ref["grads"].items():
        torch.testing.assert_close(program["moments"][n] / (1 - program["beta1"]), g, rtol=1e-4, atol=1e-6, msg=n)
    for n, p in ref["params"].items():
        moved = (p - start[n]).abs().max()
        torch.testing.assert_close(program["params"][n], p, rtol=0, atol=1e-2 * float(moved) + 1e-9, msg=n)


# what a planted BatchNorm fault leaves out of every eval-mode BatchNorm
BATCH_NORM_PARTS = ("mean", "var", "gain", "shift", "all")


@contextlib.contextmanager
def batch_norm_dropping(part: str):
    """A fault planted in the program: every eval-mode ``FlaxBatchNorm``
    computes without ``part`` of its terms (``mean``: a running mean of 0;
    ``var``: a running variance of 1; ``gain``: 1; ``shift``: 0; ``all``:
    all four, which leaves BatchNorm out but for the factor
    (1 + eps)^-1/2)."""
    from tacorl_tpu_torch.networks.encoders import FlaxBatchNorm

    original = FlaxBatchNorm.forward

    def forward(self, x):
        if self.training:
            return original(self, x)
        drop = lambda p, t, v: torch.full_like(t, v) if part in (p, "all") else t  # noqa: E731
        mean, var = drop("mean", self.running_mean, 0.0), drop("var", self.running_var, 1.0)
        gain, shift = drop("gain", self.weight, 1.0), drop("shift", self.bias, 0.0)
        mul = torch.rsqrt(var + self.eps) * gain
        return (x.float() - mean[:, None, None]) * mul[:, None, None] + shift[:, None, None]

    FlaxBatchNorm.forward = forward
    try:
        yield
    finally:
        FlaxBatchNorm.forward = original


@pytest.mark.parametrize("part", BATCH_NORM_PARTS)
def test_a_batch_norm_fault_comes_out_not_correct(tiny_store, part):
    """The seed's BatchNorm terms are not 0 and 1, so a program that drops
    any of them fails the cell's limits."""
    workload, config = r3m_cell()
    with batch_norm_dropping(part):
        r = harness.run("lmp_r3m_k16_b64", 20221018, 0.2, False, time.perf_counter(), device="cpu",
                        workload=workload, config=config, data_cache=tiny_store, metrics=[])
    print(part, r["numbers"])
    assert not r["correct"], r["numbers"]


def _reference_and_store(tiny_store, config):
    reference = importlib.import_module(f"perfbench.reference.{config['reference']}")
    return reference, data.ensure_store(config["dataset"], cache=tiny_store)


def test_the_control_trains_every_leaf_the_reference_trains(tiny_store):
    _, config = r3m_cell()
    sizes = config["sizes"]
    reference, store = _reference_and_store(tiny_store, config)
    weights = reference.weights(sizes, 11, torch.device("cpu"))["full"]
    batches = reference.batches(store, sizes, 11, harness.SNAP_STEPS, torch.device("cpu"))
    ref = reference.train_steps(weights, batches, sizes, 11, 0, "f32")
    low = reference.train_steps(weights, batches, sizes, 11, 0, "control")
    assert set(ref["grads"]) == set(low["grads"])
    for n, g in ref["grads"].items():
        if float(g.abs().max()) > 0:
            moved = compare.norm(ref["params"][n] - weights[n])
            assert compare.norm(low["params"][n] - weights[n]) == pytest.approx(moved, rel=0.5), n
    # the control's float8 operands move the frozen trunk's features
    assert float((ref["losses"]["total_loss"] - low["losses"]["total_loss"]).abs().max()) > 0


def test_the_flop_count_agrees_with_the_counter_on_the_reference(tiny_store):
    workload, config = r3m_cell()
    sizes = config["sizes"]
    reference, store = _reference_and_store(tiny_store, config)
    flops = harness.load_file(harness.HERE / "flops" / f"{workload['config']}.py", "flops_r3m")
    cpu = torch.device("cpu")
    weights = reference.weights(sizes, 5, cpu)["full"]
    batches = reference.batches(store, sizes, 5, 1, cpu)
    torch.backends.mha.set_fastpath_enabled(False)  # the counter cannot see inside the fused path
    try:
        with FlopCounterMode(display=False) as counter:
            reference.train_steps(weights, batches, sizes, 5, 0)
    finally:
        torch.backends.mha.set_fastpath_enabled(True)
    assert sum(flops.step_flops(sizes).values()) == counter.get_total_flops()


def test_the_backbone_class_is_resnet18_at_224():
    workload, config = harness.cell("lmp_r3m_k16_b64")
    flops = harness.load_file(harness.HERE / "flops" / f"{workload['config']}.py", "flops_r3m_prod")
    counts = flops.step_flops(config["sizes"])
    assert set(counts) == set(config["precision"])
    # ResNet-18 at 224x224: 1.82 G multiply-adds a frame, 1,024 frames a step
    frames = config["sizes"]["batch_size"] * config["sizes"]["max_window_size"]
    assert counts["backbone"] / 2 / frames == pytest.approx(1.82e9, rel=0.01)
    record = harness.Record(workload, config)
    record.step_flops = counts
    # the backbone's 3.7 TFLOP take at least 3.75 ms at the bfloat16 peak
    assert 3.7e-3 < record.least_step_s() < 5e-3


def test_the_seeds_backbone_keeps_the_pooled_features_in_scale(tiny_store):
    """Kaiming-normal trunks with BatchNorm terms drawn from the seed: the pooled
    features' RMS after each stage stays between 0.1 and 10 on the set's
    frames augmented at 224x224, so a lower precision cannot hide in
    features that vanish or blow up."""
    _, config = harness.cell("lmp_r3m_k16_b64")
    sizes = config["sizes"]
    reference = importlib.import_module("perfbench.reference.play_lmp_r3m")
    common = importlib.import_module("perfbench.reference.common")
    store = data.ensure_store(dict(tiny.DATASET, image_hw=sizes["image_hw"]), cache=tiny_store)
    batch = reference.batches(store, dict(sizes, batch_size=1), 3, 1, torch.device("cpu"))[0]
    gen = torch.Generator().manual_seed(3)
    frames = common.augment_rgb(batch["rgb_static"][:, :4], gen, sizes["augment"], common.Precision("f32"))
    for seed in (1, 3221225473):
        rms = reference.stage_rms(sizes, seed, frames.reshape(-1, 3, 224, 224))
        assert len(rms) == 4 and all(0.1 < r < 10 for r in rms), (seed, rms)


def _record_with(ops, steps):
    record = harness.Record(*harness.cell("lmp_r3m_k16_b64"))
    record.trace = trace.Trace((0, 10**9), ops, {})
    record.steps = steps
    return record


def test_the_device_span_reader_pairs_the_markers():
    b, e = "tacorl_span_begin_encoder_backbone", "tacorl_span_end_encoder_backbone"
    ops = [(b, 0, 10), ("conv", 10, 500), (e, 510, 515), ("adam", 600, 700),
           (b, 1000, 1010), ("conv", 1010, 1400), (e, 1410, 1415)]
    record = _record_with(ops, 2)
    assert device_spans.intervals(record, "encoder_backbone") == ([500, 400], 2)
    assert device_spans.ms_per_step(record, "encoder_backbone") == pytest.approx(450e-6)
    record.step_flops = {"backbone": 989e12 * 225e-9}
    assert harness.reader("backbone_mfu.device").read(record) == pytest.approx(50.0)
    # a program without the markers: the readers are silent
    bare = _record_with([("conv", 10, 500)], 2)
    bare.step_flops = record.step_flops
    assert harness.reader("backbone_ms.device").read(bare) is None
    assert harness.reader("backbone_mfu.device").read(bare) is None
    # an end that lost its begin is left out
    later = [(n, s + 100, t + 100) for n, s, t in ops]
    assert device_spans.intervals(_record_with([(e, 5, 6)] + later, 2), "encoder_backbone") == ([500, 400], 3)


# -- on the card -------------------------------------------------------------------------


@pytest.mark.chip
def test_the_jitter_kernel_at_224_agrees_with_its_plain_version(card):
    from tacorl_tpu_torch.ops.jitter_aug import (jitter_normalize, jitter_normalize_geometry,
                                                 jitter_normalize_reference, sample_jitter_factors)

    gen = torch.Generator(device=card).manual_seed(1)
    images = (torch.rand((1024, 3, 224, 224), generator=gen, device=card) * 255).to(torch.bfloat16)
    factors = sample_jitter_factors(1024, gen, prob=1.0)
    assert jitter_normalize_geometry(1024, 224, 224)["cluster"] == 8
    got = jitter_normalize(images, factors)
    want = jitter_normalize_reference(images, factors)
    torch.cuda.synchronize()
    # both round the same float32 chain to bfloat16: at most one bfloat16 step apart
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=2 ** -7)


@pytest.mark.chip
def test_a_sound_run_is_correct(card):
    workload, config = harness.cell("lmp_r3m_k16_b64")
    harness.set_cache_dirs()
    r = harness.run("lmp_r3m_k16_b64", 4294967311, 0.0, False, time.perf_counter(),
                    workload=dict(workload, warm_chunks=1), config=config, metrics=[])
    assert r["correct"], r["checks"]


@pytest.mark.chip
def test_the_control_comes_out_not_correct(card):
    workload, config = harness.cell("lmp_r3m_k16_b64")
    harness.set_cache_dirs()
    values = readings.control_numbers(workload, config, 20221018, card)
    assert not compare.judge(values, config["limits"])["correct"], values


@pytest.mark.chip
@pytest.mark.parametrize("part", BATCH_NORM_PARTS)
def test_a_batch_norm_fault_is_not_correct_on_the_card(card, part):
    workload, config = harness.cell("lmp_r3m_k16_b64")
    harness.set_cache_dirs()
    with batch_norm_dropping(part):
        r = harness.run("lmp_r3m_k16_b64", 4294967321, 0.0, False, time.perf_counter(),
                        workload=dict(workload, warm_chunks=1), config=config, metrics=[])
    print(f"batch norm without {part}: {r['numbers']}")
    assert not r["correct"], r["numbers"]


def _traced_backbone(steps_per_call: int, chunks: int) -> tuple:
    """A traced window of ``chunks`` chunks of the cell at K =
    ``steps_per_call``: (the reader's backbone ms a step, the kernels' ms
    between the markers a step)."""
    workload, config = harness.cell("lmp_r3m_k16_b64")
    workload = dict(workload, steps_per_call=steps_per_call, warm_chunks=2 * 16 // steps_per_call,
                    trace_chunks=chunks)
    record = {}
    original = harness.trace.reduce

    def keep(prof):
        record["trace"] = original(prof)
        return record["trace"]

    harness.trace.reduce = keep
    try:
        r = harness.run("lmp_r3m_k16_b64", 4294967317, 0.0, True, time.perf_counter(), workload=workload,
                        config=config, metrics=[{"name": "backbone_ms.device", "unit": "ms"}])
    finally:
        harness.trace.reduce = original
    ops = sorted(record["trace"].device_ops, key=lambda op: op[1])
    inside, kernel_ns, spans = False, 0, 0
    for name, s, e in ops:
        if name == "tacorl_span_begin_encoder_backbone":
            inside, spans = True, spans + 1
        elif name == "tacorl_span_end_encoder_backbone":
            inside = False
        elif inside and not name.startswith(("Memcpy", "Memset")):
            kernel_ns += e - s
    return r["metrics"]["backbone_ms.device"]["value"], kernel_ns * 1e-6 / spans


@pytest.mark.chip
def test_replays_read_the_backbones_time(card):
    harness.set_cache_dirs()
    replayed, replayed_kernels = _traced_backbone(16, 2)
    eager_span, eager_kernels = _traced_backbone(1, 8)
    print(f"backbone ms a step: replays {replayed:.4f} (kernels {replayed_kernels:.4f}), "
          f"eager span {eager_span:.4f} (kernels {eager_kernels:.4f})")
    assert replayed == pytest.approx(eager_kernels, rel=0.1)
