"""How many device records torch.profiler loses at the ends of a session
as a process ages, measured with ``chip_smoke.py``'s own profiling (the
spin-kernel pads of ``chip_smoke._profiled``), for the checkout given.

    python gennbv_tpu_torch/tools/profile_loss.py [--tree DIR] [--rounds N]

Each round runs unprofiled work (200 products of 4096x4096 float32
matrices and 20,000 element-wise adds), then profiles five sessions of 20
calls of one add and five of 5 calls of 3,000 adds, and checks each
session's count of device activities a call exactly.  Prints, per round,
the most pads lost on each side of a session and the wrong counts so far
(a session that kept no pad on one side is printed by ``_profiled`` and
taken again); the last line is the same as one JSON object.  Needs a CUDA
card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    parser.add_argument("--rounds", type=int, default=10)
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch
    import chip_smoke

    if not torch.cuda.is_available():
        raise SystemExit("profile_loss: no CUDA device")
    print(f"card: {chip_smoke.card_line()}; {chip_smoke.PROFILE_PADS} pads "
          f"of {chip_smoke.PAD_CYCLES} cycles on each side")
    x = torch.zeros(4096, device="cuda")
    big = torch.rand(4096, 4096, device="cuda")

    def adds(k: int) -> torch.Tensor:
        y = x
        for _ in range(k):
            y = y + 1
        return y

    t0 = time.perf_counter()
    rounds, wrong = [], 0
    for r in range(args.rounds):
        for _ in range(200):
            big = (big @ big).clamp_(-1, 1)
        adds(20000)
        torch.cuda.synchronize()
        chip_smoke.PADS_LOST.update(leading=0, trailing=0)
        for calls, k in ((20, 1), (5, 3000)):
            for _ in range(5):
                per_call = chip_smoke.profile_calls(lambda: adds(k), calls)[0]
                wrong += per_call != k
        rounds.append({"seconds": time.perf_counter() - t0,
                       **chip_smoke.PADS_LOST})
        print(f"round {r} at {rounds[-1]['seconds']:.1f} s: at most "
              f"{rounds[-1]['leading']} leading and {rounds[-1]['trailing']} "
              f"trailing pads lost a session; wrong counts so far {wrong}",
              flush=True)
    print(json.dumps({"pads": chip_smoke.PROFILE_PADS, "rounds": rounds,
                      "wrong_counts": wrong}))


if __name__ == "__main__":
    main()
