"""fastpath.preprocess_s: seconds a job of the phase "preprocess" (the fused
preprocess of a batch, detection nested in it booked to detection),
exclusive of phases nested inside it, from the phase clock of a traced run
(phases.py)."""

PHASE = "preprocess"
WRAPS = [("nightlight_tpu_torch.models.fastpath", "run_fused_preprocess")]


def read(rec):
    if not rec["entries"].get(PHASE):
        return None
    return rec["phases_s"][PHASE] / rec["jobs"]
