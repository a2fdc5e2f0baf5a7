"""Episode state/reward plotter (a copy of
``gennbv_tpu/utils/episode_plotter.py``, which the port cannot import:
importing it runs the JAX package's ``__init__``) -- counterpart of
legged_gym/utils/logger.py, the matplotlib playback plotter.

Collect per-step scalars during a rollout, then render a grid of subplots
to a PNG (headless Agg backend).  matplotlib is imported by ``plot`` only:
nothing else of the port needs it.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional


class EpisodePlotter:
    def __init__(self, dt: float = 1.0):
        self.dt = dt
        self._series: Dict[str, List[float]] = defaultdict(list)
        self._rewards: Dict[str, List[float]] = defaultdict(list)

    def log_state(self, key: str, value: float):
        self._series[key].append(float(value))

    def log_states(self, d: Dict[str, float]):
        for k, v in d.items():
            self.log_state(k, v)

    def log_reward(self, key: str, value: float):
        self._rewards[key].append(float(value))

    def plot(self, path: Optional[str] = None, cols: int = 3):
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        import numpy as np

        keys = list(self._series.keys())
        n = len(keys) + (1 if self._rewards else 0)
        if n == 0:
            raise ValueError("nothing logged")
        rows = -(-n // cols)
        fig, axes = plt.subplots(rows, cols, figsize=(4 * cols, 2.5 * rows),
                                 squeeze=False)
        flat = axes.reshape(-1)
        for ax, key in zip(flat, keys):
            y = self._series[key]
            ax.plot(np.arange(len(y)) * self.dt, y)
            ax.set_title(key, fontsize=9)
            ax.grid(alpha=0.3)
        if self._rewards:
            ax = flat[len(keys)]
            for key, y in self._rewards.items():
                ax.plot(np.arange(len(y)) * self.dt, np.cumsum(y), label=key)
            ax.set_title("cumulative rewards", fontsize=9)
            ax.legend(fontsize=7)
            ax.grid(alpha=0.3)
        for ax in flat[n:]:
            ax.axis("off")
        fig.tight_layout()
        if path:
            fig.savefig(path, dpi=110)
            plt.close(fig)
            return path
        return fig
