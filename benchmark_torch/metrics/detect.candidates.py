"""detect.candidates: star candidates a command that survive detection's
phase 2, the bad-pixel test (detect/stars.py), and so go into its phases
3-6, from the program's always-on counter detect.candidates over every
command the run's process ran (the warm-up, the window and the profiled
jobs); a count of detection's work, the same on the sharded path. Per command: one CLI stack, or
one served request (osc16.rgb.n20's job runs three commands). None without
profiled jobs (off the card) or on a program without the tracer."""

from benchmark_torch import spans


def read(rec):
    return spans.counter_per_command(rec, "detect.candidates")
