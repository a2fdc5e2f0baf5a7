"""The rollout's device seconds an iteration (``algo/rollout.py``,
``env/recon_env.py``, ``models/policy.py``): the Runner's own
``time/rollout`` span (CUDA events), as its logger writes it to
``metrics.jsonl``, averaged over the window's iterations."""
READS = ("time/rollout",)


def read(rec):
    phases = rec.get("phases") or []
    values = [p[READS[0]] for p in phases if READS[0] in p]
    return sum(values) / len(values) if values else None
