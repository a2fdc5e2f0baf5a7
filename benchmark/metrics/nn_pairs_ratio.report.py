"""The point pairs the program's nearest-neighbour passes compute an
episode (its counter ``accuracy/nn_pairs``: query rows times target
columns of every chunk, padding and grouping included, over the traced
run's profiled episodes, counted by ``eval/episodes``), over the least
pairs of the benchmark's frozen count (``work/chamfer.py``, from its
reference's point counts at the checked episodes)."""
from benchmark.work import chamfer

READS = ("accuracy/nn_pairs",)


def read(rec):
    counts, counted = rec.get("nn_counts"), rec.get("counted") or {}
    computed = counted.get(READS[0])
    if not counts or not computed:
        return None
    return computed / chamfer.pairs(counts)
