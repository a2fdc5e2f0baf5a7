"""The "eval_exact" traffic: the held-out eval episodes of ``eval.py``
(the same set-up, window, trace, deterministic actions and comparison) on
a configuration of the exact-mapping path (``renderer.mode`` "dda"),
judged by the exact reference env (``reference/env_exact.py``) in place
of the splat one.

The policy is the configuration's trained one (its ``"weights"`` file,
``trained.py``), the same for every seed, where ``eval.py`` draws random
weights from the seed: a random-weight policy's mode puts the 50 envs on
nearly one pose at every step, and the march runs until its longest ray
ends, so each seed's rate was a draw of that one pose.  The eval scenes
and the reset are the protocol's own, so every episode of every run takes
the same actions; the seed picks the episodes checked.

The reference's march also counts the voxels each ray reads, at the
checked episode's poses, which are the profiled episodes': the ray
march's least work (``work/raymarch.py``)."""
from __future__ import annotations

import contextlib
import types

from benchmark import harness, trained
from benchmark.loops import eval as eval_loop
from benchmark.reference import env_exact


class Loop(eval_loop.Loop):
    def setup(self, seconds: float) -> None:
        weights = trained.load(self.cell.config["weights"], self.device)
        with _swapped(harness, "weights", lambda model, seed, device: weights):
            super().setup(seconds)

    def check(self) -> dict:
        made = []

        def exact_env(cfg, scenes, grid_res):
            made.append(env_exact.Env(cfg, scenes, grid_res))
            return made[-1]

        with _swapped(eval_loop, "ref_env",
                      types.SimpleNamespace(Env=exact_env)):
            numbers = super().check()
        t_max = self.eval_env_cfg()["max_episode_length"]
        # the last checked episode's reset and steps
        self.marched = made[-1].marched[-(t_max + 1):] \
            if made and len(made[-1].marched) > t_max else None
        return numbers

    def layer_records(self, kind: str) -> dict:
        """``eval.py``'s, without the splat calls (this path has none),
        with each profiled env step's march: (voxels read, rays, distinct
        scenes, render resolution)."""
        out = super().layer_records(kind)
        out.pop("zbuf_calls", None)
        if out.get("spans") is not None and self.marched is not None:
            r = self.cfg["env"]["renderer"]["resolution"]
            out["raymarch_calls"] = [m + (r,) for m in self.marched] \
                * eval_loop.PROFILED_EPISODES
        return out


@contextlib.contextmanager
def _swapped(owner, name: str, value):
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)
