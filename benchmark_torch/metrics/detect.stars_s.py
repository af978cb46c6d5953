"""detect.stars_s: seconds a job of the phase "detect" (star detection),
exclusive of phases nested inside it, from the phase clock of a traced run
(phases.py)."""

PHASE = "detect"
WRAPS = [("nightlight_tpu_torch.detect.stars", "find_stars_batch"),
         ("nightlight_tpu_torch.detect.stars", "find_stars")]


def read(rec):
    if not rec["entries"].get(PHASE):
        return None
    return rec["phases_s"][PHASE] / rec["jobs"]
