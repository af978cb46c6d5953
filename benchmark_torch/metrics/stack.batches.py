"""stack.batches: the batches the stack's planner makes a command
(pipeline/ops_stack.py, OpStackBatches._partition), from the program's
always-on counter stack.batches over every command the run's process ran;
1 where the night fits one batch, more where it is split into a stack of
stacks. Per command: one CLI stack. None without profiled jobs (off the
card) or on a program without the counter."""

from benchmark_torch import spans


def read(rec):
    return spans.counter_per_command(rec, "stack.batches")
