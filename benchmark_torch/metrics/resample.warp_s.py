"""resample.warp_s: seconds a job of the phase "warp" (the warp into the
reference frame), exclusive of phases nested inside it, from the phase clock
of a traced run (phases.py)."""

PHASE = "warp"
WRAPS = [("nightlight_tpu_torch.ops.resample", "warp_shift_batch"),
         ("nightlight_tpu_torch.ops.resample", "project")]


def read(rec):
    if not rec["entries"].get(PHASE):
        return None
    return rec["phases_s"][PHASE] / rec["jobs"]
