"""align.align_s: seconds a job of the phase "align" (alignment), exclusive of
phases nested inside it, from the phase clock of a traced run (phases.py)."""

PHASE = "align"
WRAPS = [("nightlight_tpu_torch.align.aligner", "Aligner.align_batch"),
         ("nightlight_tpu_torch.align.aligner", "Aligner.align_one")]


def read(rec):
    if not rec["entries"].get(PHASE):
        return None
    return rec["phases_s"][PHASE] / rec["jobs"]
