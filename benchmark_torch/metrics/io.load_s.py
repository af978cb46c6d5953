"""io.load_s: seconds a job of the phase "load" (ingest: the read-ahead
loader's get (its wait for a worker, the decode) and every direct FITS
read), exclusive of phases nested inside it, from the phase clock of a
traced run (phases.py)."""

PHASE = "load"
WRAPS = [("nightlight_tpu_torch.io.ingest", "ReadAheadLoader.get"),
         ("nightlight_tpu_torch.io.fits", "read_file")]


def read(rec):
    if not rec["entries"].get(PHASE):
        return None
    return rec["phases_s"][PHASE] / rec["jobs"]
