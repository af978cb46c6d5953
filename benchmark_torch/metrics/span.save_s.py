"""span.save_s: seconds a command of the program's "save" spans (writers:
io/fits.py write_file, io/jpeg.py write_jpg and write_mono_jpg, with their
save.fetch, save.encode and save.write sub-spans), exclusive of the layer
spans nested inside, from the program's own spans
(nightlight_tpu_torch/trace.py) in the profiled jobs of a traced run
(benchmark_torch/spans.py), with no synchronisation added. Per command: one
CLI stack, or one served request (osc16.rgb.n20's job runs three commands).
None without profiled jobs (off the card) or on a program without the
tracer."""

from benchmark_torch import spans


def read(rec):
    return spans.layer_s(rec, "save")
