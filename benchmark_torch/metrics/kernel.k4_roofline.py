"""kernel.k4_roofline: the share of its roofline that kernel gather_patches
(csrc/gather_patches.cu) reached in the profiled jobs of a traced run: the
sum of each call's bound (roofline.py: the larger of its bytes at the HBM
rate and its operations at the float32 rate) over the kernel's summed device
time, in %."""

KERNEL = "gather_patches"


def read(rec):
    k = rec.get("kernels", {}).get(KERNEL)
    if not k or k["calls"] == 0 or k["device_s"] <= 0:
        return None
    return 100.0 * k["bound_s"] / k["device_s"]
