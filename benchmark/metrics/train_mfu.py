"""The whole training iteration's share of the card's float32 peak: the
matmul and convolution FLOPs of one iteration, counted by the benchmark
on its reference policy (``work/flops.py``: each rollout step's forward,
the last values' forward, forward and backward of each minibatch the
update applied by the Runner's ``train/n_minibatches``, and the forward
of the one a KL stop refused), over that iteration's unprofiled
seconds (the Runner's fetch spacing, ``time/iter_seconds``), summed over
the window, against ``work/peaks.json``."""
READS = ("time/iter_seconds", "train/n_minibatches")


def read(rec):
    peaks, seconds = rec.get("peaks"), sum(rec.get("unit_seconds") or [])
    if not peaks or not seconds:
        return None
    return 100.0 * sum(rec["unit_flops"]) / seconds / peaks["float32_flops"]
