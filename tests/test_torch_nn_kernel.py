"""Tests of the nearest-neighbour kernel (``csrc/nn_min.cu`` through
``ops/nn_min.py``, ``chamfer._row_mins`` on CUDA tensors): its minima bit
for bit those of the plain loop (``chamfer._row_mins_ref``) run on the same
card, over random clouds at several N, P and Q (tails that no tile
divides, masks with holes, an env with no valid target and one with no
query, coordinates up to 20 m), ``exclude_self`` beside duplicate points,
and the report cell's shapes (50 envs, up to 8,192 GT points); the card's
``batched_accuracy`` against its CPU run and the benchmark's float64
reference; and the counters.  Those skip on a machine without a card.
The tests at the end run on the CPU: the wrapper's refusals, a CPU
``batched_accuracy`` launches nothing and reads as before the kernel, the
card path's pair count against the least, and the report's faults still
reach ``_row_mins``.  This file imports no jax, so where jax is missing
run it without the conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_nn_kernel.py
"""
import test_torch_threads  # noqa: F401  (one torch thread a worker)

import numpy as np
import pytest
import torch

from benchmark import faults_report
from benchmark.reference import accuracy as ref_accuracy
from benchmark.work import chamfer as work_chamfer
from gennbv_tpu_torch import config
from gennbv_tpu_torch.algo import evaluation
from gennbv_tpu_torch.env import make_scenes
from gennbv_tpu_torch.ops import chamfer, kernels, nn_min
from gennbv_tpu_torch.utils import profiling
from gennbv_tpu_torch.utils.work import WorkCounter

BIG = chamfer._BIG
# the report cell's accuracy limit (benchmark/limits/ref400.report.json)
ACCURACY_GAP = 3e-7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def _clouds(seed, n, p, q, scale=20.0, device="cuda"):
    """n envs of p queries and q targets uniform in [-scale, scale]^3,
    rounded to 1 cm as the report's scans are, with random masks whose
    valid points thin out towards the end (holes and ragged extents)."""
    rng = np.random.default_rng(seed)
    a = np.round(rng.uniform(-scale, scale, (n, p, 3)), 2).astype(np.float32)
    b = np.round(rng.uniform(-scale, scale, (n, q, 3)), 2).astype(np.float32)
    am = rng.random((n, p)) < np.linspace(1.0, 0.3, p)
    bm = rng.random((n, q)) < np.linspace(1.0, 0.3, q)
    return [torch.as_tensor(x, device=device) for x in (a, am, b, bm)]


def _held(a, am, b, bm, exclude_self=False, chunk=256):
    """The kernel's minima (through ``chamfer._row_mins``) against the
    plain loop's on the card, bit for bit; one launch counted a call.
    Returns them."""
    before = kernels.launches()["nn_min"]
    got = chamfer._row_mins(a, am, b, bm, chunk, exclude_self)
    assert kernels.launches()["nn_min"] == before + (a.numel() > 0)
    want = chamfer._row_mins_ref(a, am, b, bm, chunk, exclude_self)
    assert got.dtype == torch.float32 and got.shape == am.shape
    assert torch.equal(got, want)
    return got


@pytest.mark.parametrize("n,p,q", [(1, 1, 1), (3, 37, 5), (2, 300, 1031),
                                   (5, 1027, 2049), (4, 2500, 8192)])
@pytest.mark.parametrize("exclude_self", [False, True])
def test_kernel_equals_plain_on_random_clouds(cuda, n, p, q, exclude_self):
    """Random clouds up to 20 m with ragged masks; P and Q that no CTA's
    256 rows, warp's 64 or tile's 1,024 targets divide (8,192 takes the
    masks' 16-byte path); with exclude_self, a and b the same points."""
    a, am, b, bm = _clouds(n * p + q, n, p, q)
    if exclude_self:
        b, bm = a, am
    got = _held(a, am, b, bm, exclude_self)
    assert (got[~am] == BIG).all()
    if not (exclude_self and p == 1):
        assert (got[am] < BIG).any()


def test_an_env_without_targets_or_queries(cuda):
    """An env with no valid target reads 1e10 on every row, one with no
    valid query 1e10 everywhere, its neighbours unchanged; no target at
    all (Q = 0) reads 1e10."""
    a, am, b, bm = _clouds(7, 4, 600, 900)
    bm[1] = False
    am[2] = False
    got = _held(a, am, b, bm)
    assert (got[1] == BIG).all() and (got[2] == BIG).all()
    assert (got[0][am[0]] < BIG).all() and (got[3][am[3]] < BIG).all()
    alone = _clouds(8, 1, 5, 1)[0]
    got = chamfer._row_mins(alone, torch.ones(1, 5, dtype=torch.bool,
                                              device="cuda"),
                            alone[:, :0], torch.zeros(1, 0, dtype=torch.bool,
                                                      device="cuda"), 256)
    assert (got == BIG).all()


def test_exclude_self_skips_only_the_index(cuda):
    """A point duplicated at other indices still finds them at distance
    0; the points' own index alone is skipped, and a point with no other
    valid point reads 1e10."""
    a, am, _, _ = _clouds(9, 2, 700, 1)
    a[0, 400] = a[0, 3]
    a[0, 650] = a[0, 3]
    a[1, 299] = a[1, 300]
    am[0, [3, 400, 650]] = True
    am[1, [299, 300]] = True
    got = _held(a, am, a, am, exclude_self=True)
    assert got[0, 3] == got[0, 400] == got[0, 650] == 0.0
    assert got[1, 299] == got[1, 300] == 0.0
    single = am.clone()
    single[1] = False
    single[1, 10] = True
    got = _held(a, single, a, single, exclude_self=True)
    assert got[1, 10] == BIG


def _cell_inputs(envs=50):
    """The report cell's passes' inputs (``chip_smoke.nn_scans``): the
    held-out eval's scenes (scene seed 100 at R = 64, up to 8,192 GT
    points each) and, for each, a scan of ~3,000-4,500 points near its
    surface, rounded to 1 cm and deduplicated as the eval dedupes its
    views."""
    import chip_smoke
    return chip_smoke.nn_scans(make_scenes(
        config.SceneConfig(num_scenes=envs, seed=100), 64, "cuda"))


def test_kernel_equals_plain_at_the_cells_shapes(cuda):
    """The three passes of ``batched_accuracy`` at the report cell's
    shapes (50 envs, scans padded to a multiple of 1,024, GT to 8,192):
    bit-equal to the plain loop on the card."""
    import chip_smoke
    passes, counts = chip_smoke.nn_passes(make_scenes(
        config.SceneConfig(num_scenes=50, seed=100), 64, "cuda"))
    assert passes[0][2].shape[1] == 8192 and max(g for _, g in counts) <= 8192
    for args in passes:
        _held(*args)


def test_batched_accuracy_on_card_equals_cpu_and_reference(cuda):
    """Two envs at the cell's shapes: the card's six numbers equal the
    CPU's and lie within the cell's accuracy_gap of the benchmark's
    float64 reference; one launch a pass, its pairs counted from the
    host masks (``nn_min.pairs``), no fewer than the least."""
    deduped, gt, gt_mask, vox = _cell_inputs(envs=2)
    profiling.reset_counters("accuracy/")
    before = kernels.launches()["nn_min"]
    on_card = evaluation.batched_accuracy(deduped, gt, gt_mask, vox)
    assert kernels.launches()["nn_min"] == before + 3
    counted = profiling.counters("accuracy/")["accuracy/nn_pairs"]
    on_cpu = evaluation.batched_accuracy(deduped, gt, gt_mask, vox,
                                         device="cpu")
    assert on_card == on_cpu
    least = work_chamfer.pairs([(len(p), int(m))
                                for p, m in zip(deduped, gt_mask.sum(1))])
    assert least <= counted < 1.1 * least
    want = ref_accuracy.accuracy(deduped, torch.as_tensor(gt, device="cuda"),
                                 torch.as_tensor(gt_mask, device="cuda"), vox)
    for name, got in zip(ref_accuracy.NAMES, on_card):
        gap = abs(got - want[name])
        if name != "gt_unseen_frac":
            gap /= abs(want[name])
        assert gap <= ACCURACY_GAP, name


def test_the_last_chunk_fault_reaches_the_card(cuda):
    """``benchmark/faults_report.nn_last_chunk_skipped`` patches
    ``chamfer._row_mins``, which the card's passes reach: under it the
    scan-to-GT term reads the 1e10 of the skipped rows."""
    deduped, gt, gt_mask, vox = _cell_inputs(envs=2)
    sound = evaluation.batched_accuracy(deduped, gt, gt_mask, vox)
    with faults_report.nn_last_chunk_skipped():
        faulty = evaluation.batched_accuracy(deduped, gt, gt_mask, vox)
    assert sound[1] < 1.0 and faulty[1] > 1e6


def test_kernel_counters(cuda):
    """``kernel/nn_min/launches`` counts one a call; inside a WorkCounter
    the call adds ``nn_min.work``'s operations and bytes."""
    args = _clouds(11, 3, 500, 700)
    before = kernels.launches()["nn_min"]
    nn_min.nn_min(*args)
    nn_min.nn_min(*args, exclude_self=False)
    assert kernels.launches()["nn_min"] == before + 2
    nbytes, ops = nn_min.work(*args)
    with WorkCounter() as counted:
        nn_min.nn_min(*args)
    assert counted.flops == ops > 0 and counted.bytes >= nbytes


# --- on the CPU -------------------------------------------------------------

@pytest.mark.parametrize("case", ["cpu", "float64", "int_mask", "no_xyz",
                                  "leading", "mask_shape"])
def test_the_wrapper_refuses_what_the_kernel_does_not_take(case):
    """CPU tensors (the CPU's path is the plain loop), points other than
    float32, masks other than bool, points without 3 coordinates, a and b
    of different leading shapes, masks of other shapes."""
    a, am, b, bm = _clouds(1, 2, 5, 7, device="cpu")
    error = {"cpu": ValueError, "float64": TypeError,
             "int_mask": TypeError}.get(case, ValueError)
    args = {"cpu": (a, am, b, bm), "float64": (a.double(), am, b, bm),
            "int_mask": (a, am.int(), b, bm), "no_xyz": (a[..., :2], am, b, bm),
            "leading": (a, am, b[:1], bm[:1]),
            "mask_shape": (a, am[:, :4], b, bm)}[case]
    with pytest.raises(error, match="CUDA" if case == "cpu" else "nn_min"):
        nn_min.nn_min(*args)


# a CPU batched_accuracy's six numbers and pair count on _accuracy_case's
# inputs, as the plain loop gave them before the kernel existed
BEFORE = ((2984.546994633433, 1421.079540148098, 1563.4674544853349,
           8.616032223392649, 0.8031319842947751, 1840.675187399989),
          5_667_200)


def _accuracy_case():
    rng = np.random.default_rng(25)
    n, m = 4, 700
    gt = rng.uniform(-20, 20, size=(n, m, 3)).astype(np.float32)
    gt_mask = np.zeros((n, m), bool)
    for e, k in enumerate((700, 513, 0, 64)):
        gt_mask[e, :k] = True
    gt_mask[1, 100:140] = False
    deduped = [np.unique(np.round(
        gt[e, :300] + rng.normal(size=(300, 3)).astype(np.float32) * 0.3, 2),
        axis=0).astype(np.float32) for e in range(2)]
    deduped += [np.zeros((0, 3), np.float32),
                np.round(rng.uniform(-20, 20, (77, 3)), 2).astype(np.float32)]
    return deduped, gt, gt_mask, np.array([0.2, 0.3, 0.25, 0.5], np.float32)


def test_a_cpu_batched_accuracy_launches_nothing_and_reads_as_before():
    """On the CPU the passes are the plain loop, grouped as before: the
    six numbers and the pairs counted are those it gave before the kernel,
    and no kernel launches."""
    kernels.reset_launches()
    profiling.reset_counters("accuracy/")
    got = evaluation.batched_accuracy(*_accuracy_case(), device="cpu")
    assert (got, profiling.counters("accuracy/")["accuracy/nn_pairs"]) \
        == BEFORE
    assert set(kernels.launches().values()) == {0}


def _kernel_pairs(a_mask, b_mask):
    """The kernel's pairs counted one warp at a time: each warp's 64 rows
    where one holds a valid query, times the env's target extent rounded
    up to 4."""
    total = 0
    for am, bm in zip(a_mask, b_mask):
        valid = np.flatnonzero(bm)
        extent = -(-(valid[-1] + 1 if len(valid) else 0) // 4) * 4
        for w0 in range(0, len(am), 64):
            total += 64 * extent * bool(am[w0:w0 + 64].any())
    return total


@pytest.mark.parametrize("sizes,m", [((1500, 20, 0, 700), 900),
                                     ((64, 65, 1), 8192)])
def test_the_card_pair_count_is_at_least_the_least(sizes, m):
    """``nn_min.pairs`` on the host masks of the three passes, as
    ``batched_accuracy`` counts the card's: the kernel's rule, warp by
    warp, and no fewer than the frozen count's least pairs."""
    rng = np.random.default_rng(m)
    n = len(sizes)
    gt_mask = np.zeros((n, m), bool)
    for e in range(n):
        gt_mask[e, :rng.integers(1, m + 1)] = True
    gt_mask[0, 5:9] = False
    pmax = -(-max(sizes) // 1024) * 1024
    smask = np.arange(pmax)[None] < np.array(sizes)[:, None]
    counted = 0
    for am, bm in ((smask, gt_mask), (gt_mask, smask), (gt_mask, gt_mask)):
        assert nn_min.pairs(am, bm) == _kernel_pairs(am, bm)
        counted += nn_min.pairs(am, bm)
    least = work_chamfer.pairs(zip(sizes, gt_mask.sum(1)))
    assert counted >= least > 0


def test_the_report_faults_reach_row_mins():
    """``faults_report``'s two pass faults patch ``chamfer._row_mins`` and
    ``chamfer._sq_dists``: on the CPU each moves batched_accuracy, and
    ``_row_mins`` there is the plain loop."""
    case = _accuracy_case()
    a, am, b, bm = _clouds(3, 2, 40, 50, device="cpu")
    assert torch.equal(chamfer._row_mins(a, am, b, bm, 16),
                       chamfer._row_mins_ref(a, am, b, bm, 16))
    sound = evaluation.batched_accuracy(*case, device="cpu")
    with faults_report.nn_last_chunk_skipped():
        skipped = evaluation.batched_accuracy(*case, device="cpu")
    with faults_report.nn_expanded():
        expanded = evaluation.batched_accuracy(*case, device="cpu")
    assert skipped[1] > 1e6 > sound[1]
    assert expanded != sound


def test_the_work_count_of_a_call():
    """``nn_min.work``: 16 bytes a valid query (read, its minimum
    written), 12 a valid target; OPS_PER_PAIR a pair of valid points of
    one env."""
    a, am, b, bm = _clouds(5, 2, 9, 11, device="cpu")
    sa, sb = am.sum(1), bm.sum(1)
    assert nn_min.work(a, am, b, bm) == (
        int(16 * sa.sum() + 12 * sb.sum()),
        nn_min.OPS_PER_PAIR * int((sa * sb).sum()))
