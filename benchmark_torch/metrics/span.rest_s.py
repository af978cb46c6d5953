"""span.rest_s: seconds a command of the command span's own time (cli.py main,
or a served request's job): its wall less every layer span inside it, so
operator dispatch, reference selection, logging and host work between
layers, from the program's own spans in the profiled jobs of a traced run
(benchmark_torch/spans.py). Per command: one CLI stack, or one served
request (osc16.rgb.n20's job runs three commands). None without profiled
jobs (off the card) or on a program without the tracer."""

from benchmark_torch import spans


def read(rec):
    return spans.value(rec, "rest_s")
