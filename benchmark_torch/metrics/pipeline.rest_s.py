"""pipeline.rest_s: seconds a job outside every phase of the phase clock
(operator dispatch, reference selection, the per-frame log, host work
between phases): the window's wall less every phase, over its jobs."""


def read(rec):
    return (rec["wall_s"] - sum(rec["phases_s"].values())) / rec["jobs"]
