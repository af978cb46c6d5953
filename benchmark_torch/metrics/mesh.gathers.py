"""mesh.gathers: the all-gathers of a row-sharded value to the lead card a
command under -shard (parallel/mesh.py, RowSharded.gather; the saves take
the whole frame), from the program's counter mesh.gathers, summed over its
sites, over every command the run's process ran. None without profiled
jobs (off the card), without a gather, or on a program without the
counter."""

from benchmark_torch import spans


def read(rec):
    return spans.counter_per_command(rec, "mesh.gathers")
