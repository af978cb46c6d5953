"""pipeline.perframe_s: seconds a job of the phase "perframe" (the per-frame
operators: calibrate, bad pixels, location and scale, histogram match),
exclusive of phases nested inside it, from the phase clock of a traced run
(phases.py)."""

PHASE = "perframe"
WRAPS = [("nightlight_tpu_torch.pipeline.ops_pre", "OpCalibrate.apply"),
         ("nightlight_tpu_torch.pipeline.ops_pre", "OpBadPixel.apply"),
         ("nightlight_tpu_torch.ops.stats", "Stats._update_location_scale"),
         ("nightlight_tpu_torch.pipeline.ops_post", "OpMatchHistogram.apply")]


def read(rec):
    if not rec["entries"].get(PHASE):
        return None
    return rec["phases_s"][PHASE] / rec["jobs"]
