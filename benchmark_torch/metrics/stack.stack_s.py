"""stack.stack_s: seconds a job of the phase "stack" (the goal-seek and the
stack), exclusive of phases nested inside it, from the phase clock of a
traced run (phases.py)."""

PHASE = "stack"
WRAPS = [("nightlight_tpu_torch.ops.findsigma", "find_sigmas_and_stack"),
         ("nightlight_tpu_torch.ops.stack", "stack")]


def read(rec):
    if not rec["entries"].get(PHASE):
        return None
    return rec["phases_s"][PHASE] / rec["jobs"]
