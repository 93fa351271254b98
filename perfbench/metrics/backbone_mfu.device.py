"""The frozen visual backbone's share of its roofline: the least time of
its operations (the ``backbone`` op class of flops/<config>.py, at the
peak of the precision the configuration states for it, peaks.py) over its
time on the card (``backbone_ms.device``)."""

from perfbench import device_spans, peaks


def read(record):
    flops = record.step_flops.get("backbone")
    ms = device_spans.ms_per_step(record, "encoder_backbone")
    if not flops or not ms:
        return None
    least_s = flops / peaks.FLOPS_PER_S[record.config["precision"]["backbone"]]
    return 100.0 * least_s / (ms * 1e-3)
