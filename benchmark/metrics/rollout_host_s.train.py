"""The host's seconds in an iteration's rollout (``algo/rollout.py``
under the Runner's device-timed span ``rollout``): the median over the
profiled ``Runner.train`` call's iterations (three) of each one's
``rollout`` span.  Beside ``rollout_s.train`` (the device's seconds of
the same span) it says whether the rollout is host-bound.  Read from
the program's spans of the device-only profile (``benchmark/spans.py``),
so each launch carries the profiler's cost, as on every side."""
import statistics

from benchmark import spans

READS = ("rollout",)
MARGIN_S = 10.0


def read(rec):
    units = spans.session(rec, MARGIN_S)
    per_unit = [sum(s.end_ns - s.start_ns for s in ss if s.name == READS[0])
                for ss in units.values()
                if any(s.name == READS[0] for s in ss)]
    if not per_unit:
        return None
    return statistics.median(per_unit) / 1e9
