"""Device launches and device time of each kernel wrapper's call, on the
inputs that ``chip_smoke.py``'s phase 3 gives it (a step of the 400x400
eval and of the 128x128 rollout), for the checkout given.  Every device
activity a call makes counts: the kernel's, and any fill or copy that the
wrapper launches beside it.

    python gennbv_tpu_torch/tools/profile_wrappers.py [--tree DIR] [--calls N]

``--tree`` is the root of a checkout of the repo (default: the one this
file is in); its ``chip_smoke.py`` and ``gennbv_tpu_torch`` are the ones
imported and built.  To compare two commits on one card, unpack the other
with ``git archive`` and run the script on both trees in turns in one
process chain.  Prints, per kernel and path, the device activities a call
(with their names) and their device ms a call, over `--calls` back-to-back
calls under ``torch.profiler``, three times; the last line is the same as
one JSON object.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    parser.add_argument("--calls", type=int, default=50)
    args = parser.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch
    import chip_smoke
    from gennbv_tpu_torch import config
    from gennbv_tpu_torch.ops import fused_splat, gather, scatter

    if not torch.cuda.is_available():
        raise SystemExit("profile_wrappers: no CUDA device")
    print(f"tree {tree}; card: {chip_smoke.card_line()}")
    out: dict = {}
    for path, cfg, hw in (
            ("eval", chip_smoke.eval_config("pallas"), chip_smoke.EVAL_HW),
            ("rollout", chip_smoke.flagship_config(), chip_smoke.HW)):
        scenes = chip_smoke.make_path_scenes(cfg, path)
        cam = config.CameraConfig(height=hw, width=hw)
        (vic, uic, z, ok, veps), (idx, valid), (img, vi, ui) = \
            chip_smoke._step_inputs(scenes, cam)
        calls = {
            "zbuf_visible": lambda: fused_splat.zbuf_visible(
                vic, uic, z, ok, veps, hw, hw, cam.depth_max),
            "scatter_cells_any": lambda: scatter.scatter_cells_any(
                idx, valid, chip_smoke.G),
            "gather_image": lambda: gather.gather_image(img, vi, ui),
        }
        for name, fn in calls.items():
            runs = [chip_smoke.profile_calls(fn, args.calls) for _ in range(3)]
            out.setdefault(name, {})[path] = {
                "launches_per_call": runs[0][0],
                "device_ms": [r[1] for r in runs],
                "names": sorted(n[:80] for n in runs[0][2])}
            print(f"{path}: {name}: {runs[0][0]:g} device activities a call "
                  f"({', '.join(out[name][path]['names'])}); device ms a call "
                  + " / ".join(f"{r[1]:.5f}" for r in runs))
    print(json.dumps({"tree": tree, "wrappers": out}))


if __name__ == "__main__":
    main()
