"""leaf_rows_per_ray: leaf rows the split walks fetched (a lane fetching a
row counts once) over their live rays, summed over every split walk of the
traced frames; None unless the program counted them
(``harness/split_walk.py``)."""

from benchmark.harness import split_walk


def read(rec):
    walks = split_walk.traced_counts(rec)
    if walks is None:
        return None
    live = sum(w["live"] for w in walks)
    return sum(w["leaf_fetches"] for w in walks) / live if live else None
