"""mesh.bytes: bytes copied between the cards of a -shard mesh a command,
from the program's always-on counter mesh.bytes (parallel/mesh.py: each
gather's blocks of every card but the lead's, the halo rows a warp takes
from its neighbours, the blocks a split sends from the lead), counted from
shapes on the host, over every command the run's process ran. None without
profiled jobs (off the card), without a copy between cards, or on a
program without the counter."""

from benchmark_torch import spans


def read(rec):
    return spans.counter_per_command(rec, "mesh.bytes")
