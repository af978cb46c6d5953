"""host.reads: blocking host reads a command on the command's own thread: each
host_read span of the program (trace.to_host, trace.upload, trace.host_read:
a device-to-host copy, a read of a value, nonzero, or an upload from
pageable memory, all of which wait for the card's queue), which the program
counts in its counter host.reads by layer, in the profiled jobs of a traced
run (benchmark_torch/spans.py). Per command: one CLI stack, or one served
request (osc16.rgb.n20's job runs three commands). None without profiled
jobs (off the card) or on a program without the tracer."""

from benchmark_torch import spans


def read(rec):
    return spans.value(rec, "reads")
