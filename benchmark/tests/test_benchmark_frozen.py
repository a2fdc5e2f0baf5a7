"""The benchmark's frozen copies equal the program's originals today: the
FLOP rules (``work/flops.py`` against ``utils/work.py``), the splat
kernel's least work (``work/splat.py`` against ``ops/fused_splat.work``)
and the scene generator (``reference/scenes.py`` against
``env/scene.py``), at the cells' shapes."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.reference import policy as ref_policy
from benchmark.reference import scenes as ref_scenes
from benchmark.work import flops, splat

torch.set_num_threads(1)


def test_flop_count_equals_the_programs_counter():
    from gennbv_tpu_torch.utils.work import WorkCounter
    model = harness.find_cell(harness.load_spec(),
                              "flagship128.train").config["config"]["model"]
    pol = ref_policy.Policy(model, "cpu")
    obs = torch.rand(8, 16792)
    for train in (False, True):
        pol.train(train)

        def step():
            logits, value = pol(obs)
            if train:
                (logits.sum() + value.sum()).backward()

        with flops.FlopCounter() as ours:
            step()
        with WorkCounter() as theirs:
            step()
        assert ours.flops == theirs.flops > 0


@pytest.mark.parametrize("n,q,h,w", [(50, 9216, 400, 400), (256, 11264, 128, 128),
                                     (3, 40, 16, 16)])
def test_splat_work_equals_the_kernels_formula(n, q, h, w):
    from gennbv_tpu_torch.ops import fused_splat
    g = torch.Generator().manual_seed(n)
    ok = torch.rand(n, q, generator=g) < 0.3
    z = torch.rand(n, q, generator=g)
    vic = torch.zeros(n, q, dtype=torch.int32)
    assert splat.work(n, q, int(ok.sum()), h, w) == fused_splat.work(
        vic, vic, z, ok, torch.zeros(n), h, w)


def test_scenes_equal_the_programs_generator():
    from gennbv_tpu_torch.config import SceneConfig
    from gennbv_tpu_torch.env.scene import generate_procedural
    ours = ref_scenes.generate(3, 7, 32, 20)
    theirs = generate_procedural(SceneConfig(num_scenes=3, seed=7), 32,
                                 device="cpu")
    for k, v in ours.items():
        np.testing.assert_array_equal(v, getattr(theirs, k).numpy(), err_msg=k)
