"""detect.finish_launches: launches of the star-detection finish kernel (K8
detect_finish, nightlight_tpu_torch/csrc/detect_finish.cu) a job, from the
program's launch counter (nightlight_tpu_torch.kernels.launch_counts) over
the window: one a detection (each light and the stacked image), so it shows
that every detection path finishes through the kernel. None on a program
without the kernel."""


def read(rec):
    if "detect_finish" not in rec["launches"]:
        return None
    return rec["launches"]["detect_finish"] / rec["jobs"]
