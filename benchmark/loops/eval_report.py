"""The "eval_report" traffic: the post-training report's held-out eval,
``algo.evaluation.evaluate(env, policy, point_stride, compute_accuracy=
True)`` back to back, as ``tools/post_run.py --eval_cam 400`` runs it on
its held-out family: ``eval.py``'s episodes (the same set-up, window,
trace, deterministic actions and comparison) with each view's accuracy
scan, each env's 1 cm dedupe and the three nearest-neighbour passes
against the scenes' GT point clouds.

The policy is the configuration's trained one (its ``"weights"`` file,
``trained.py``), the same for every seed, loaded as ``eval_exact.py``
loads it: a report evaluates a trained checkpoint, and a random-weight
policy's mode puts the envs on nearly one pose, so the scan's point
count would be a draw of that pose.  Every episode of every run takes
the same actions; the seed picks the episodes checked.

Each episode's ``Episodes`` (``evaluation.run_episodes``, wrapped here:
the scan's points and masks, already on the host) rides on the result
it returns, so the window keeps those of its checked episodes alone.
The check adds to the eval's own comparison every view's scan against
the plain reference's march and back-projection at the poses the
reference env takes from the program's actions, and the six accuracy
numbers against the reference's float64 nearest neighbours
(``reference/accuracy.py``).  The reference's point counts at the
checked episodes, which take the profiled episodes' actions, are the
least work of the passes (``work/chamfer.py``).
"""
from __future__ import annotations

import math
import sys
import types

import numpy as np
import torch

from benchmark import compare, harness, spans, trained
from benchmark.compare import NO_READING
from benchmark.loops import eval as eval_loop
from benchmark.loops.eval_exact import _swapped
from benchmark.reference import accuracy as ref_accuracy
from benchmark.reference import env as ref_env
from gennbv_tpu_torch.algo import evaluation

# the spans of an episode whose host time the traced run prints
EPISODE_PARTS = ("eval/reset", "eval/step", "eval/scan", "eval/fetch",
                 "eval/results", "eval/accuracy", "eval/accuracy/dedupe",
                 "eval/accuracy/nn")
ACCURACY_WORK = ("eval/scan", "eval/fetch", "eval/accuracy")
COUNTED = ("accuracy/nn_pairs", "accuracy/scan_points")
# the device-only session's episodes lie within a millisecond of its
# records (NVIDIA H100, PERF.md)
MARGIN_S = 0.1


class Loop(eval_loop.Loop):
    def setup(self, seconds: float) -> None:
        path = self.cell.config.get("weights")
        if path is None:
            raise ValueError("the report evaluates a trained policy: the "
                             "configuration names no \"weights\" file")
        weights = trained.load(path, self.device)
        self.stride = self.traffic["point_stride"]
        with _swapped(harness, "weights",
                      lambda model, seed, device: weights):
            super().setup(seconds)

    def _episode(self):
        run = evaluation.run_episodes
        kept = []

        def keeping(*args, **kwargs):
            kept.append(run(*args, **kwargs))
            return kept[-1]

        with _swapped(evaluation, "run_episodes", keeping):
            result = self.evaluate(self.env, self.policy,
                                   point_stride=self.stride,
                                   compute_accuracy=True)
        out = _Report(*result)
        out.episodes = kept[0]
        return out

    def trace(self) -> None:
        """``eval.py``'s profiles, with the accuracy counters an episode
        over them (none where the program has no such counter) and the
        host time of the device-only session's episode parts, printed."""
        from gennbv_tpu_torch.utils import profiling
        before = profiling.counters()
        super().trace()
        after = profiling.counters()
        episodes = after.get("eval/episodes", 0) \
            - before.get("eval/episodes", 0)
        self.records["counted"] = {
            k: (after.get(k, 0) - before.get(k, 0)) / episodes
            for k in COUNTED} if episodes else {}
        units = spans.session({"spans": self.records["profile"].spans},
                              MARGIN_S)
        took = {k: sum(s.end_ns - s.start_ns for s in spans.named(units, k))
                / 1e9 for k in ("eval/episode",) + EPISODE_PARTS}
        whole = took["eval/episode"]
        if whole:
            work = sum(took[k] for k in ACCURACY_WORK)
            print("report episodes, host seconds: " + ", ".join(
                f"{k} {v:.4f}" for k, v in took.items())
                + f"; the accuracy work {100 * work / whole:.1f}% of the "
                f"episodes; counted an episode {self.records['counted']}",
                file=sys.stderr)

    def check(self) -> dict:
        """``eval.py``'s numbers, then ``scan_mismatches`` (every view's
        scan points and masks against the reference's, exact) and
        ``accuracy_gap`` (the six accuracy numbers against the reference's:
        the largest relative gap, the unseen share's absolute)."""
        views, made = [], []
        self.nn_counts = None

        class Recording(ref_env.Env):
            def __init__(self, *args):
                super().__init__(*args)
                made.append(self)

            def step(self, state, actions):
                new, out = super().step(state, actions)
                views.append((state.episode_len, state.scene_id, actions,
                              out.done))
                return new, out

        with _swapped(eval_loop, "ref_env",
                      types.SimpleNamespace(Env=Recording)):
            numbers = super().check()
        t_max = self.eval_env_cfg()["max_episode_length"]
        if numbers["env_mismatches"] == NO_READING \
                or len(views) != (t_max + 1) * len(self.checked):
            return dict(numbers, scan_mismatches=NO_READING,
                        accuracy_gap=NO_READING)
        mismatched, gap = 0, 0.0
        for i, (_, _, _, result) in enumerate(self.checked):
            want, counts, bad = self._reference(
                made[-1].sc, views[i * (t_max + 1):(i + 1) * (t_max + 1)],
                result.episodes)
            mismatched += bad
            gap = max(gap, accuracy_gap(result, want))
            self.nn_counts = counts
        return dict(numbers, scan_mismatches=mismatched, accuracy_gap=gap)

    def _reference(self, scenes: dict, views: list, ep):
        """(the reference's six numbers, each env's (deduped scan points,
        GT points), the scan's mismatched elements) of one checked
        episode, whose reset and steps are `views`: (episode_len,
        scene_id, actions, done) of each reference env step."""
        env_cfg, r = self.eval_env_cfg(), self.cfg["env"]["renderer"][
            "resolution"]
        cam = env_cfg["camera"]
        dev = scenes["surf_pts"].device
        rays = torch.as_tensor(ref_accuracy.scan_rays(
            cam["height"], cam["width"], cam["horizontal_fov_deg"],
            self.stride), device=dev)
        pts, valid, mismatched = [], [], 0
        for t, (episode_len, scene_id, actions, _) in enumerate(views):
            p, v = ref_accuracy.scan(
                scenes, scene_id, ref_accuracy.view_poses(episode_len,
                                                          actions),
                rays, r, cam)
            mismatched += compare.mismatches(
                torch.from_numpy(ep.scan_pts[t]), p) \
                + compare.mismatches(torch.from_numpy(ep.scan_valid[t]), v)
            pts.append(p.cpu().numpy())
            valid.append(v.cpu().numpy())
        dones = torch.stack([d for *_, d in views[1:]]).cpu().numpy()
        deduped = ref_accuracy.dedupe(np.stack(pts), np.stack(valid), dones)
        sid = views[0][1]
        gt, gt_mask = scenes["gt_points"][sid], scenes["gt_points_mask"][sid]
        vox = ref_accuracy.render_voxels(scenes["box_lo"][sid].cpu().numpy(),
                                         scenes["box_hi"][sid].cpu().numpy(),
                                         r)
        want = ref_accuracy.accuracy(deduped, gt, gt_mask, vox)
        counts = [(len(p), int(m)) for p, m in
                  zip(deduped, gt_mask.sum(-1).tolist())]
        return want, counts, mismatched

    def layer_records(self, kind: str) -> dict:
        """``eval.py``'s, with the accuracy counters an episode of the
        profiled episodes and each env's (deduped scan points, GT points)
        at the last checked episode."""
        out = super().layer_records(kind)
        if out.get("spans") is not None:
            out.update(counted=self.records.get("counted"),
                       nn_counts=self.nn_counts)
        return out


class _Report(evaluation.EvalResult):
    """An episode's EvalResult carrying its ``Episodes`` (``episodes``)."""


def accuracy_gap(result, want: dict) -> float:
    """The largest gap of the six accuracy numbers of `result` against the
    reference's `want`: relative to the reference's value, the unseen
    share's absolute; NO_READING where either side is not finite."""
    gap = 0.0
    for name in ref_accuracy.NAMES:
        got, ref = float(getattr(result, name)), want[name]
        if not (math.isfinite(got) and math.isfinite(ref)):
            return NO_READING
        diff = abs(got - ref)
        if name != "gt_unseen_frac":
            diff = diff / abs(ref) if ref else (0.0 if got == ref
                                                  else NO_READING)
        gap = max(gap, diff)
    return gap
