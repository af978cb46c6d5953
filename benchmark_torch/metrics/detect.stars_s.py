"""detect.stars_s: seconds a job of the phase "detect" (star detection),
exclusive of phases nested inside it, from the phase clock of a traced run
(phases.py): the whole-frame detectors and, under -shard, the sharded
one."""

PHASE = "detect"
WRAPS = [("nightlight_tpu_torch.detect.stars", "find_stars_batch"),
         ("nightlight_tpu_torch.detect.stars", "find_stars"),
         ("nightlight_tpu_torch.detect.stars", "find_stars_sharded")]


def read(rec):
    if not rec["entries"].get(PHASE):
        return None
    return rec["phases_s"][PHASE] / rec["jobs"]
