"""Device activities an env step (``env/recon_env.py``, ``models/policy.py``,
``algo/evaluation.py``): every device record in the profiled eval
episodes (kernels, copies and sets), over the batched env steps in them,
the reset counted (31 an episode)."""
READS = ("every device record between the pads",)


def read(rec):
    spans, steps = rec.get("spans"), rec.get("env_steps")
    if not spans or not steps:
        return None
    return len(spans) / steps
