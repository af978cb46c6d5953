"""host.read_wait_s: seconds a command the command's own thread spends in the
program's host_read spans (blocking reads: the wait for the card's queue and
the copy), in the profiled jobs of a traced run (benchmark_torch/spans.py).
Per command: one CLI stack, or one served request (osc16.rgb.n20's job runs
three commands). None without profiled jobs (off the card) or on a program
without the tracer."""

from benchmark_torch import spans


def read(rec):
    return spans.value(rec, "read_wait_s")
