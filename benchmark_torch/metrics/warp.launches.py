"""warp.launches: launches of the shift-blend warp kernel (K7 warp_shift,
nightlight_tpu_torch/csrc/warp_shift.cu) a job, from the program's launch
counter (nightlight_tpu_torch.kernels.launch_counts) over the window: one a
light that the shift plan warps, so it shows that the main path goes
through the kernel. 0 where every warp of the window took the gather (a
transform beyond the shift plan); None on a program without the kernel."""


def read(rec):
    if "warp_shift" not in rec["launches"]:
        return None
    return rec["launches"]["warp_shift"] / rec["jobs"]
