"""span.request_s: seconds a served request spends outside its job: the request
span's own time (serve/rest.py Handler.do_POST from the body read to the
chunked log's end, less the job's command span inside it), from the
program's own spans in the profiled jobs of a traced run
(benchmark_torch/spans.py); None in a CLI cell. Per command: one CLI stack,
or one served request (osc16.rgb.n20's job runs three commands). None
without profiled jobs (off the card) or on a program without the tracer."""

from benchmark_torch import spans


def read(rec):
    return spans.value(rec, "request_s")
