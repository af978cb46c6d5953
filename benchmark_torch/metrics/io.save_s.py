"""io.save_s: seconds a job of the phase "save" (writers: the FITS and JPEG
writers), exclusive of phases nested inside it, from the phase clock of a
traced run (phases.py)."""

PHASE = "save"
WRAPS = [("nightlight_tpu_torch.io.fits", "write_file"),
         ("nightlight_tpu_torch.io.jpeg", "write_jpg"),
         ("nightlight_tpu_torch.io.jpeg", "write_mono_jpg")]


def read(rec):
    if not rec["entries"].get(PHASE):
        return None
    return rec["phases_s"][PHASE] / rec["jobs"]
