"""The PPO update's device seconds an iteration (``algo/ppo.py``'s
Learner and its captured CUDA graph): the Runner's own ``time/update``
span (CUDA events, ``utils/profiling.PhaseTimer``), as its logger writes
it to ``metrics.jsonl``, averaged over the window's iterations."""
READS = ("time/update",)


def read(rec):
    phases = rec.get("phases") or []
    values = [p[READS[0]] for p in phases if READS[0] in p]
    return sum(values) / len(values) if values else None
