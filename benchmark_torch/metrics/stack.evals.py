"""stack.evals: launches of the stacking kernels (K1 stack_clip, K2
stack_linfit, K3 stack_single_pass) a job, from the program's launch counter
(nightlight_tpu_torch.kernels.launch_counts) over the window."""

KERNELS = ("stack_clip", "stack_linfit", "stack_single_pass")


def read(rec):
    n = sum(rec["launches"].get(k, 0) for k in KERNELS)
    return n / rec["jobs"] if n else None
