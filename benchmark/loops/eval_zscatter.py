"""The "eval_zscatter" traffic: the held-out eval episodes of ``eval.py``
(the same set-up, window, trace, deterministic actions and comparison) on
a configuration of the splat renderer's exact z-buffer
(``renderer.zbuf_impl`` "scatter"), judged by the exact z-buffer
reference env (``reference/env_zscatter.py``) in place of the two-digit
one.

The policy is the configuration's trained one (its ``"weights"`` file,
``trained.py``), the same for every seed, as in ``eval_exact.py``: a
random-weight policy's mode puts the 50 envs on nearly one pose, where a
trained one spreads them over the poses an eval visits.  The eval scenes
and the reset are the protocol's own, so every episode of every run takes
the same actions; the seed picks the episodes checked.

The scatter-min kernel reads every point and writes every pixel, so its
least work is a function of the shapes alone: ``layer_records`` gives each
profiled env step's (n, q, h, w)."""
from __future__ import annotations

import types

from benchmark import harness, trained
from benchmark.loops import eval as eval_loop
from benchmark.loops.eval_exact import _swapped
from benchmark.reference import env_zscatter


class Loop(eval_loop.Loop):
    def setup(self, seconds: float) -> None:
        weights = trained.load(self.cell.config["weights"], self.device)
        with _swapped(harness, "weights", lambda model, seed, device: weights):
            super().setup(seconds)

    def check(self) -> dict:
        with _swapped(eval_loop, "ref_env",
                      types.SimpleNamespace(Env=env_zscatter.Env)):
            return super().check()

    def layer_records(self, kind: str) -> dict:
        """``eval.py``'s, without the fused splat's calls (this path has
        none), with the scatter-min's calls: (n, q, h, w) of each
        profiled env step."""
        out = super().layer_records(kind)
        out.pop("zbuf_calls", None)
        if out.get("spans") is not None:
            env_cfg = self.eval_env_cfg()
            cam = env_cfg["camera"]
            out["zscatter_calls"] = [
                (env_cfg["num_envs"], self.arrays["surf_pts"].shape[1],
                 cam["height"], cam["width"])] * out["env_steps"]
        return out
