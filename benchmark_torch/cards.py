"""The cell's cards and what the harness does on each of them.

A cell that asks for `chips` cards runs on cuda:0 .. cuda:chips-1, and on
no other: run.main shows the process only those (CUDA_VISIBLE_DEVICES)
before CUDA starts, so the port's `-shard`, which meshes every visible
card, meshes exactly the cell's. Every wait of the harness covers all of
them, since a sharded job leaves work queued on each card; with one card
each call here is the one-card call.
"""

from __future__ import annotations

import torch


def visible() -> list:
    """Every card this process sees: the cell's cards under run.main."""
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", k) for k in range(torch.cuda.device_count())]


def of_cell(chips: int) -> list:
    """cuda:0 .. cuda:chips-1."""
    return [torch.device("cuda", k) for k in range(int(chips))]


def synchronize(cards) -> None:
    """Wait until every card of `cards` has finished its queued work."""
    for card in cards:
        torch.cuda.synchronize(card)


def reset_peaks(cards) -> None:
    for card in cards:
        torch.cuda.reset_peak_memory_stats(card)


def peaks(cards, read=torch.cuda.max_memory_allocated) -> list:
    """Each card's peak of allocated bytes since its reset, in the order of
    `cards`. The cell's peak is the largest (the fullest card sets how
    large a night fits), not the sum: a sharded job holds a block of every
    frame on each card."""
    return [int(read(card)) for card in cards]
