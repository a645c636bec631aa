"""Readings of a traced run over several cards: each card's busy time,
the part of it inside the program's span records, and the link the cards
exchange over.

A register split over the cell's cards has one shard on each; the trace's
device events carry their card (``DeviceEvent.card``).
"""

from __future__ import annotations

from qtbench import trace as TR

# One direction of the NVLink between two H100 SXM5 cards that an NVSwitch
# joins: 18 NVLink 4 links of 25 GB/s each way (NVIDIA H100 data sheet,
# "NVLink: 900 GB/s" both ways).  On the four-card H100 80GB HBM3 host the
# benchmark runs on, `nvidia-smi topo -m` does not run, every pair of cards
# has peer access, and one pair's peer copy moves 374-392 GB/s one way:
# more than the 6 links that join a pair on a four-card board without a
# switch carry (150 GB/s), so the pair meets through a switch on all 18.
LINK_BYTES_PER_S = 450e9


def cards(trace: TR.Trace) -> list:
    """The indices of the cards the trace saw work on, in order."""
    return sorted({ev.card for ev in trace.device})


def busy_inside(trace: TR.Trace, card: int, records: list) -> float:
    """Seconds in which card ``card`` was busy inside the records'
    intervals (the union of its device events' intervals, met with the
    union of the records')."""
    spans = TR.busy_intervals(
        [TR.DeviceEvent("span", r["start_ns"] * 1e-9, r["end_ns"] * 1e-9)
         for r in records])
    busy = TR.busy_intervals([ev for ev in trace.device if ev.card == card])
    total, j = 0.0, 0
    for s, e in spans:
        while j < len(busy) and busy[j][1] <= s:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < e:
            total += min(e, busy[k][1]) - max(s, busy[k][0])
            k += 1
    return total
