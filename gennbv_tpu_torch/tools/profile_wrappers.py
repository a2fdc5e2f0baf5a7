"""Device launches and device time of each kernel wrapper's call, on the
inputs that ``chip_smoke.py``'s phase 3 gives it (a step of the 400x400
eval and of the 128x128 rollout), for the checkout given.  Every device
activity a call makes counts: the kernel's, and any fill or copy that the
wrapper launches beside it.

    python gennbv_tpu_torch/tools/profile_wrappers.py [--tree DIR] [--calls N]
        [--only NAME ...] [--cold] [--zbuf-rows R ...]

``--tree`` is the root of a checkout of the repo (default: the one this
file is in); its ``chip_smoke.py`` and ``gennbv_tpu_torch`` are the ones
imported and built.  To compare two commits on one card, unpack the other
with ``git archive`` and run the script on both trees in turns in one
process chain.  Prints, per kernel and path, the device activities a call
(with their names) and their device ms a call, over `--calls` back-to-back
calls under ``torch.profiler``, three times, the calls of a path taken in
turns (forward, backward, forward); the last line is the same as one JSON
object.  ``--only`` keeps the wrappers whose names start so.  ``--cold``
adds, in each turn, the call's time from CUDA events by ``chip_smoke.py``'s
own yardsticks: warm (back to back) and cold (one call after a 100 MB L2
flush that leaves clean lines, or dirty ones), and once a trivial launch's
cold time after each flush (the floor); a tree whose ``chip_smoke.py`` has
no clean flush is timed by this checkout's.  ``--zbuf-rows`` times the
scatter-min's kernel (``zbuf_scatter.launch``) with bands of each height
given that fits, on as many CTAs as the card holds of each, beside the
wrapper's geometry.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _yardsticks(chip_smoke):
    """The module whose timing helpers time the calls: the tree's
    chip_smoke, or this checkout's where the tree's has no clean flush."""
    if hasattr(chip_smoke, "_l2_flush"):
        return chip_smoke
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", default=HERE)
    parser.add_argument("--calls", type=int, default=50)
    parser.add_argument("--only", nargs="+", default=None)
    parser.add_argument("--cold", action="store_true")
    parser.add_argument("--zbuf-rows", type=int, nargs="+", default=[])
    args = parser.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch
    import chip_smoke
    from gennbv_tpu_torch import config
    from gennbv_tpu_torch.ops import fused_splat, gather, scatter, zbuf_scatter

    if not torch.cuda.is_available():
        raise SystemExit("profile_wrappers: no CUDA device")
    print(f"tree {tree}; card: {chip_smoke.card_line()}")
    out: dict = {}
    if args.cold:
        timer = _yardsticks(chip_smoke)
        out["floor"] = {k: timer.cold_floor_ms(k) for k in ("read", "zero")}
        print(f"a trivial launch cold: {out['floor']['read']:.5f} ms after a "
              f"clean flush, {out['floor']['zero']:.5f} ms after a dirty one")
    for path, cfg, hw in (
            ("eval", chip_smoke.eval_config("pallas"), chip_smoke.EVAL_HW),
            ("rollout", chip_smoke.flagship_config(), chip_smoke.HW)):
        scenes = chip_smoke.make_path_scenes(cfg, path)
        cam = config.CameraConfig(height=hw, width=hw)
        (vic, uic, z, ok, veps), (idx, valid), (img, vi, ui) = \
            chip_smoke._step_inputs(scenes, cam)
        flat, zz = chip_smoke.exact_zbuf_inputs(vic, uic, z, ok, hw,
                                                cam.depth_max)
        calls = {
            "zbuf_visible": lambda: fused_splat.zbuf_visible(
                vic, uic, z, ok, veps, hw, hw, cam.depth_max),
            "scatter_cells_any": lambda: scatter.scatter_cells_any(
                idx, valid, chip_smoke.G),
            "gather_image": lambda: gather.gather_image(img, vi, ui),
            "zbuf_scatter_min": lambda: zbuf_scatter.zbuf_scatter_min(
                flat, zz, hw, hw, cam.depth_max),
        }
        if args.zbuf_rows:
            n, q = flat.shape
            sms = zbuf_scatter.sm_count(flat.get_device())
            for rows in args.zbuf_rows:
                if rows > hw or not zbuf_scatter.fits(rows, hw):
                    continue
                bands = -(-hw // rows)
                geo = zbuf_scatter.Geometry(rows, bands, min(n * bands, sms))
                calls[f"zbuf_scatter_min, {geo.bands} bands of {geo.rows} "
                      f"rows on {geo.ctas} CTAs"] = (
                    lambda geo=geo: zbuf_scatter.launch(
                        flat, zz, hw, hw, cam.depth_max, geo))
        names = [name for name in calls if not args.only
                 or any(name.startswith(o) for o in args.only)]
        res = {name: out.setdefault(name, {}).setdefault(path, {
            "device_ms": [], **({"warm_ms": [], "cold_ms": [],
                                 "cold_dirty_ms": []} if args.cold else {})})
               for name in names}
        for turn in range(3):
            for name in names if turn % 2 == 0 else names[::-1]:
                fn, r = calls[name], res[name]
                per_call, device_ms, acts = chip_smoke.profile_calls(
                    fn, args.calls)
                r["launches_per_call"] = per_call
                r["names"] = sorted(a[:80] for a in acts)
                r["device_ms"].append(device_ms)
                if args.cold:
                    r["warm_ms"].append(timer._time_ms(fn))
                    r["cold_ms"].append(timer._time_cold_ms(fn))
                    r["cold_dirty_ms"].append(
                        timer._time_cold_ms(fn, flush="zero"))
        for name in names:
            r = res[name]
            print(f"{path}: {name}: {r['launches_per_call']:g} device "
                  f"activities a call ({', '.join(r['names'])}); device ms a "
                  "call " + " / ".join(f"{t:.5f}" for t in r["device_ms"])
                  + ("" if not args.cold else "; warm " + " / ".join(
                      f"{t:.5f}" for t in r["warm_ms"]) + " ms, cold "
                     + " / ".join(f"{t:.5f}" for t in r["cold_ms"])
                     + " ms, cold after a dirty flush " + " / ".join(
                         f"{t:.5f}" for t in r["cold_dirty_ms"])
                     + " ms (CUDA events)"))
    print(json.dumps({"tree": tree, "wrappers": out}))


if __name__ == "__main__":
    main()
