"""The host's seconds in an iteration's PPO update (``algo/ppo.py``: the
Learner's 1,280 graph replays enqueued, under the Runner's device-timed
span ``update``): the median over the profiled ``Runner.train`` call's
iterations (three) of each one's ``update`` span, any time the host
waits on a full launch queue included.  Read from the program's spans of
the device-only profile (``benchmark/spans.py``)."""
import statistics

from benchmark import spans

READS = ("update",)
MARGIN_S = 10.0


def read(rec):
    units = spans.session(rec, MARGIN_S)
    per_unit = [sum(s.end_ns - s.start_ns for s in ss if s.name == READS[0])
                for ss in units.values()
                if any(s.name == READS[0] for s in ss)]
    if not per_unit:
        return None
    return statistics.median(per_unit) / 1e9
